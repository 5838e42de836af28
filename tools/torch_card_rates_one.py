#!/usr/bin/env python3
"""Rank 0's work of the four-card rates (`chip_smoke.card_rates_rank`) on
one card, in a one-rank NCCL group: the flagship's one-card trainer built,
read and closed, then the long clip's one-card trainer
(`chip_smoke.CARD_RATES["longclip_strong"]`, batch 8 as 4 micro-batches)
beside a trainer of one rank's share of the four ranks' global batch
(batch 2, grad_accum 1), each warmed up at steps_per_call 1 and 2, then
the readings of `chip_smoke.RATE_TURNS`. It prints each stage with the
device memory allocated and reserved, each entry's row, and any error
with its traceback; the rank's own stdout goes to DIR/rank0.log.

    python3 tools/torch_card_rates_one.py [--out DIR]

One GPU; exits 1 when an entry failed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import traceback

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402  (imports no part of the port)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "card_rates_one"))
    args = ap.parse_args()
    import torch

    from dvdgan_tpu_torch.parallel import mesh as pmesh
    if not torch.cuda.is_available():
        print("torch_card_rates_one: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    for line in chip_smoke.gpu_lines():
        print(line, flush=True)
    _, one_argv, k, n = chip_smoke.CARD_RATES["longclip_strong"]
    rates = {
        "flagship_strong": chip_smoke.CARD_RATES["flagship_strong"],
        "longclip_strong": (chip_smoke.LONG_ARGV + [
            "--batch_size", str(8 // chip_smoke.CARDS), "--grad_accum", "1"],
            one_argv, k, n),
    }
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(pmesh.free_port()))
    try:
        chip_smoke.card_rates_rank(0, args.out, rates, cards=1)
        rc = 0
    except BaseException:
        traceback.print_exc(file=sys.__stdout__)
        print(torch.cuda.memory_summary(abbreviated=True),
              file=sys.__stdout__, flush=True)
        rc = 1
    finally:
        sys.stdout = sys.__stdout__
    path = os.path.join(args.out, "rates_rank0.json")
    if os.path.exists(path):
        with open(path) as f:
            print("rows " + f.read(), flush=True)
    print(json.dumps({"ok": rc == 0}), flush=True)
    return rc


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)      # a failed rank leaves its NCCL group undestroyed
