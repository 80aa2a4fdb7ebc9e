#!/usr/bin/env python3
"""How far K1 and its plain version lie from the attention in float64, at
the tower's two sequence lengths, over several seeds.

    python3 scripts/k1_float64_spread.py [SEEDS [FIRST_SEED]]

For N = 10 (the CLIP presets' 96 px images) and N = 50 (224 px), B = 128,
256 and 512, h = 12, d = 64, bf16, and seeds FIRST_SEED ..
FIRST_SEED+SEEDS-1 (default 8 from 100, the draws phase 3 pools):
`chip_smoke.float64_check` of K1 (through `fused_attention`) and of its
plain version against `chip_smoke.attention_float64` on
`chip_smoke.k1_inputs`. Prints one JSON line a shape (the outputs that
differ from the float64 ones, kernel and plain, each seed and summed; the
ratio of the sums; whether each seed passes phase 3's check), one line a
N on whether the batch changes an image's outputs (the first four B = 128
draws run again as one B = 512 batch: the outputs of each that differ
from their B = 128 run, kernel and plain), and a last line with the sums
over the seeds at each N. Needs one CUDA card and the repository around
it.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    import torch

    from lossyless_tpu_torch.nn import flash_attn as fa

    seeds = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    first = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    print(cs.card_line(), flush=True)
    totals = {}
    with torch.inference_mode():
        for N in (10, 50):
            small = []  # (qkv, kernel, plain) of the first B = 128 draws
            for B in (128, 256, 512):
                rows = []
                for seed in range(first, first + seeds):
                    (qkv,) = cs.k1_inputs(B, N, 12, 64, torch.bfloat16,
                                          seed=seed)
                    got = fa.fused_attention(qkv, 12)
                    plain = fa.attention_plain(qkv, 12)
                    ref = cs.attention_float64(qkv, 12)
                    check = cs.float64_check(got, plain, ref)
                    if B == 128 and len(small) < 4:
                        small.append((qkv, got, plain))
                    rows.append(dict(seed=seed,
                                     kernel=int((got != ref).sum()),
                                     plain=int((plain != ref).sum()),
                                     far_kernel=check["far_kernel"],
                                     far_plain=check["far_plain"],
                                     ok=check["ok"]))
                k = sum(r["kernel"] for r in rows)
                p = sum(r["plain"] for r in rows)
                t = totals.setdefault(N, dict(kernel=0, plain=0, n=0))
                t["kernel"] += k
                t["plain"] += p
                t["n"] += seeds * B * N * 768
                print(json.dumps(dict(N=N, B=B, outputs=B * N * 768,
                                      kernel_sum=k, plain_sum=p,
                                      ratio=k / max(p, 1),
                                      passes=sum(r["ok"] for r in rows),
                                      seeds=rows)), flush=True)
            qkv = torch.cat([q for q, _, _ in small])
            print(json.dumps(dict(
                N=N, batch_invariance=f"{len(small)} x B=128 as one batch",
                kernel_outputs_changed=int(
                    (fa.fused_attention(qkv, 12) !=
                     torch.cat([g for _, g, _ in small])).sum()),
                plain_outputs_changed=int(
                    (fa.attention_plain(qkv, 12) !=
                     torch.cat([p for _, _, p in small])).sum()))),
                flush=True)
    print(json.dumps({"totals": {N: dict(t, ratio=t["kernel"] /
                                         max(t["plain"], 1))
                                 for N, t in totals.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
