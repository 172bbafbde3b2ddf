"""The local training work of each server update in chip_smoke.py's phase
5d, on the CPU in seconds: the port's event engine runs 5d's three specs
with a learner that trains nothing and counts, for every update, its
contributing clients and their local steps (a client trains min(its
batches, max_client_steps) steps, so the count varies with its data).

    PYTHONPATH=src python scripts/local_steps.py

prints one JSON line a mode: ``[[clients, local steps], ...]`` an update.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as C  # noqa: E402
from repro_torch.api import Experiment, ModelRef  # noqa: E402
from repro_torch.data import FederatedDataset  # noqa: E402


class StepCounter:
    """The engine's learner protocol, counting work instead of doing it."""

    real = True

    def __init__(self, spec, cfg):
        self.fed, self.max_steps = spec.federated, spec.max_client_steps
        self.dataset = FederatedDataset(
            vocab_size=cfg.vocab_size, seq_len=spec.seq_len,
            char_vocab=cfg.char_vocab, max_word_len=cfg.max_word_len)
        self.version, self.steps, self.updates = 0, 0, []

    def _steps(self, client_id):
        batches = self.dataset.client_batches(
            client_id, self.fed.client_batch_size, self.fed.local_epochs)
        return min(len(batches), self.max_steps)

    def client_deltas(self, client_ids, version=None):
        self.steps += sum(self._steps(c) for c in client_ids)
        return [None] * len(client_ids), [1.0] * len(client_ids)

    def client_delta(self, client_id, version=None):
        self.steps += self._steps(client_id)
        return None, 1.0

    def apply(self, deltas, weights, **_):
        self.updates.append([len(deltas), self.steps])
        self.steps = 0
        self.version += 1

    def eval_perplexity(self):
        return 1e4


def main():
    for mode in C.MODES:
        spec = C.experiment_spec(mode, ModelRef("paper-charlm"), C.SEQ_LEN,
                                 C.CONCURRENCY, C.GOAL, C.BATCH)
        exp = Experiment(spec)
        counter = StepCounter(spec, exp.model_config)
        Experiment(spec, learner=counter).run()
        print(json.dumps({"mode": mode, "updates": counter.updates}))


if __name__ == "__main__":
    main()
