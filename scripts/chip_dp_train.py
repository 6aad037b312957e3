"""``chip_smoke.py``'s 17b (``ApexTrainer.train`` at dp 2 over gloo with
4 actor processes) of the checkout at ROOT, once, on one card: builds
that checkout's gather kernel and prints one ``RESULT`` JSON line with
its learner steps/s and the update all-reduce's host ms per step.

Run from any directory on a machine with a card::

    python3 scripts/chip_dp_train.py ROOT

To compare two checkouts on one card, run it for each in turns in one
session: parent, change, change, parent.
"""
import json
import math
import os
import sys


def main() -> None:
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs
    from apex_tpu_torch.ops import gather

    torch.cuda.get_device_name(0)     # the card initialised first
    gather.build()
    out = cs.dp_train_run(torch.device("cuda", 0), gather,
                          {"steps_per_s": math.nan},
                          {"allreduce_ms": math.nan})
    print("RESULT", json.dumps({"root": sys.argv[1],
                                "steps_per_s": out["steps_per_s"],
                                "allreduce_ms": out["allreduce_ms"]}),
          flush=True)


if __name__ == "__main__":
    main()
