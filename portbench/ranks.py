"""One rank of a run on several cards (``kinds/train.py: drive_ranks``
starts one a card):

    python3 portbench/ranks.py <spec.json>

The spec names the cell, the run's arguments, this process's rank, the
world and the rendezvous port, and the file its record is written to."""
from __future__ import annotations

import json
import pickle
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for _p in (ROOT, ROOT / "src"):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))


def main(path: str) -> int:
    spec = json.loads(Path(path).read_text())
    if spec["device"] == "cpu":
        import torch
        torch.set_num_threads(1)
    from portbench.kinds.train import drive
    rec = drive(spec["cell"], spec["seed"], spec["seconds"], spec["trace"],
                device=spec["device"], root=Path(spec["root"]),
                rank=spec["rank"], world=spec["world"], port=spec["port"])
    with open(spec["out"], "wb") as fh:
        pickle.dump(rec, fh)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
