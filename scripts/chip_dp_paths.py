"""Phase 17d-17g of ``chip_smoke.py`` alone on one card: build the gather
kernel, make phase 4's chunks, then run the sharded learner's fused
plane, ``AnakinPool``, service-batch and checkpoint sub-phases with the
same checks as the whole script, and print each one's seconds, the
paths' gather launches and the card's name and power limit.

Run from the checkout's root on a machine with a card::

    python3 scripts/chip_dp_paths.py
"""
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> None:
    import torch

    import chip_smoke as cs
    from apex_tpu_torch.ops import gather

    dev = torch.device("cuda", 0)
    print("card", torch.cuda.get_device_name(0), flush=True)
    gather.build()
    t0 = time.perf_counter()
    msgs = cs.slice_phase(dev, gather, None).pop("msgs")
    torch.cuda.empty_cache()
    t = [time.perf_counter()]
    out = {"dp_fused": cs.dp_fused_run(
        dev, gather, {"steps_per_s": math.nan, "frames_per_s": math.nan})}
    t.append(time.perf_counter())
    out["dp_anakin"] = cs.dp_anakin_run(dev, gather)
    t.append(time.perf_counter())
    out["dp_service"] = cs.dp_service_run(dev, gather)
    t.append(time.perf_counter())
    out["dp_checkpoint"] = cs.dp_checkpoint_run(dev, gather, msgs)
    t.append(time.perf_counter())
    print("seconds: slice", round(t[0] - t0, 1),
          {n: round(b - a, 1) for n, a, b in zip(out, t, t[1:])},
          flush=True)
    print(json.dumps({k: v["launches"] for k, v in out.items()}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
