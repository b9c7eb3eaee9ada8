#!/usr/bin/env python3
"""What device memory a fit leaves behind, fit after fit, in one process.

Runs ``--fits`` short fused ``w_cos`` fits (the ``w_cos`` row of
``tools/registration_rows_torch.py`` cut to ``--epochs`` epochs on a
``--shapes``-shape bank, seeds 0, 1, ...) under
``torch.cuda.memory._record_memory_history``, and prints one JSON line
with ``torch.cuda.memory_allocated()`` after each fit (its result held,
after ``del`` and after ``gc.collect()``), then one line per allocation
site of the blocks still live at the end: bytes, blocks, memory pool,
stream and the site's frames (Python and C++). Needs a card.

    python3 tools/fit_memory_torch.py --fits 3
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import gc
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import registration_rows_torch as rows  # noqa: E402


def fit(seed: int, epochs: int, shapes: int, log_dir: str):
    from shwd_torch.data import RegistrationDataset
    from shwd_torch.train import Trainer
    cfg = rows.row_config("w_cos", seed, log_dir, epochs)
    cfg = dataclasses.replace(cfg, dataset=dataclasses.replace(cfg.dataset,
                                                               num_synthetic=shapes))
    return Trainer(cfg).fit(RegistrationDataset(cfg.dataset, "train"), verbose=False)


def live_sites() -> list[dict]:
    """The live blocks of the allocator's snapshot, summed by (pool,
    stream, allocation site)."""
    size, count = collections.Counter(), collections.Counter()
    for seg in torch.cuda.memory._snapshot()["segments"]:
        for blk in seg["blocks"]:
            if blk["state"] != "active_allocated":
                continue
            site = " <- ".join(f"{f['filename'].split('/')[-1]}:{f['line']}:{f['name']}"
                               for f in blk.get("frames") or [])[:600]
            key = (str(seg.get("segment_pool_id")), seg["stream"], site or "(no frame)")
            size[key] += blk["size"]
            count[key] += 1
    return [{"MiB": n / 2**20, "blocks": count[k], "pool": k[0], "stream": k[1],
             "site": k[2]} for k, n in size.most_common()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fits", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--shapes", type=int, default=256)
    ap.add_argument("--log-dir", default="log/fit_memory")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fit_memory_torch: needs a CUDA card", file=sys.stderr)
        return 1
    torch.cuda.memory._record_memory_history(max_entries=200000)
    marks = {"start": torch.cuda.memory_allocated()}
    for i in range(args.fits):
        res = fit(i, args.epochs, args.shapes, args.log_dir)
        marks[f"fit{i}_held"] = torch.cuda.memory_allocated()
        del res
        marks[f"fit{i}_after_del"] = torch.cuda.memory_allocated()
        gc.collect()
        marks[f"fit{i}_after_gc"] = torch.cuda.memory_allocated()
    print(json.dumps(marks), flush=True)
    for site in live_sites()[:25]:
        print(json.dumps(site), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
