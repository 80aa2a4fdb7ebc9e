#!/usr/bin/env python3
"""K3's design step on one card: where each forward design's time goes,
and what the backward kernel replaces in a training step.

    python3 scripts/k3_design_step.py EARLIER_SOURCE

EARLIER_SOURCE is the K3 source of the design before the redesign (the
`coding/csrc/eb_likelihood.cu` of commit e83c186, for example unpacked
with `git archive` into a git-ignored directory such as `_archive/`).
Variants of each source are text substitutions, built with nvcc in
parallel into `_archive/k3_variants/`. Prints one JSON line each:

* `earlier_design` at (128, 512) and (128, 102), filters (3,3,3,3): the
  earlier kernel (a block per 64 channels x 4 rows, every block
  transforming its channels' coefficients) and its variants: the
  preamble alone, the chain on coefficients transformed beforehand, a
  plain copy of the coefficients, an empty launch; device ms
  (torch.profiler, `chip_smoke.device_ms`) and event ms;
* `design` at the same shapes: the current kernel and its variants: the
  table build alone, the chain alone (table left unset), each block
  transforming every coefficient itself (with and without the cluster),
  the launch floor (with and without the cluster); its forward and its
  backward (also with dz only) at 1-8 warps a block, how many clusters
  of each the card holds at once, and the warps `k3_plan` picks;
* `step_kernels`: device kernels (and copies) and busy ms a training step
  of `clip_hub` and `clip_bottleneck_pretrain` at batch 128 (3 steps
  traced after 3), with the backward kernel and with the eager backward
  it replaced (autograd through the reference chain), in turns.

Needs one CUDA card and the repository around it.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from lossyless_tpu_torch.coding import eb_kernel  # noqa: E402
from lossyless_tpu_torch.nn import _build  # noqa: E402

OUT = ROOT / "_archive" / "k3_variants"
SHAPES = ((128, 512), (128, 102))


def sub(text: str, *pairs) -> str:
    for a, b in pairs:
        if a not in text:
            raise ValueError(f"anchor not found: {a[:70]!r}")
        text = text.replace(a, b)
    return text


def earlier_variants(src: str) -> dict:
    pre_start = "  for (int idx = threadIdx.x; idx < n_ch * K; idx += blockDim.x) {"
    pre_end = ("    w[k * kChannels + c] = kind == 1 ? softplus(x) : kind == 2 ? "
               "tanhf(x) : x;\n  }")
    body_start = ("  const float v = z[i];\n  const float lower = "
                  "chain<W>(v - 0.5f, w + c, d);")
    body_end = "  out[i] = fmaxf(lik, kBound);"
    pre = src[src.index(pre_start):src.index(pre_end) + len(pre_end)]
    body = src[src.index(body_start):src.index(body_end) + len(body_end)]
    copy = """  for (int idx = threadIdx.x; idx < kChannels * K; idx += blockDim.x) {
    const int c = idx % kChannels;
    const int k = idx / kChannels;
    if (c < n_ch) w[k * kChannels + c] = coeffs[static_cast<int64_t>(c0 + c) * K + k];
  }"""
    only_w = "  out[i] = w[c] + z[i];"
    return {"full": src,
            "preamble_only": sub(src, (body, only_w)),
            "chain_pretransformed": sub(src, (pre, copy)),
            "copy_only": sub(src, (pre, copy), (body, only_w)),
            "launch_floor": sub(src, (pre, ""), (body, "  out[i] = z[i];"))}


def design_variants(src: str) -> dict:
    body = """      const float lower = chain<false>(d, t, v - 0.5f, none);
      const float upper = chain<false>(d, t, v + 0.5f, none);
      const float sum = lower + upper;
      const float s = sum > 0.f ? -1.f : (sum < 0.f ? 1.f : 0.f);
      const float lik = fabsf(sigmoid(s * upper) - sigmoid(s * lower));
      out[i] = fmaxf(lik, kBound);"""
    build = ("  build_table(a, c0, n_ch, K, table, cl);\n  cluster_arrive();  "
             "// this block reads no other table from here on\n")
    local = """  for (int pos = threadIdx.x; pos < K * kChannels; pos += blockDim.x) {
    const int c = pos % kChannels;
    if (c < n_ch) {
      const Coef e = coef_of(a, pos / kChannels);
      const float x = e.p[static_cast<int64_t>(c0 + c) * e.S + e.kk];
      table[pos] = e.kind == 0 ? softplus(x) : e.kind == 2 ? tanhf(x) : x;
    }
  }
"""
    wait = ("  cluster_wait();  // no block leaves while another may read its "
            "table\n")
    dims = ("__global__ void __cluster_dims__(kSplit, 1, 1) __launch_bounds__("
            "kThreads, 1)\n    eb_likelihood_kernel(")
    rank = ("const int64_t r0 = cl.block_rank() * warps + threadIdx.x / "
            "kChannels;")
    no_cluster = [(dims, "__global__ void __launch_bounds__(kThreads, 1)\n"
                         "    eb_likelihood_kernel("),
                  (rank, "const int64_t r0 = (blockIdx.x % kSplit) * warps "
                         "+ threadIdx.x / kChannels;")]
    return {"full": src,
            "table_only": sub(src, (body, "      out[i] = v + t(0);")),
            "chain_only": sub(src, (build, "  cluster_arrive();\n")),
            "local_table": sub(src, (build, local), (wait, "")),
            "local_table_no_cluster": sub(src, (build, local), (wait, ""),
                                          *no_cluster),
            "launch_floor": sub(src, (build, "  cluster_arrive();\n"),
                                (body, "      out[i] = v;")),
            "launch_floor_no_cluster": sub(src, (build, ""), (wait, ""),
                                           (body, "      out[i] = v;"),
                                           *no_cluster)}


def build_all(groups: dict) -> dict:
    """{(group, name): CDLL}, every variant built with one nvcc each, all
    started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for group, variants in groups.items():
        for name, text in variants.items():
            src = OUT / f"{group}_{name}.cu"
            src.write_text(text)
            lib = OUT / f"lib{group}_{name}.so"
            cmd = _build._command("eb_likelihood", lib)
            cmd[-1] = str(src)
            procs[(group, name)] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key} did not build:\n{log[-4000:]}")
        libs[key] = ctypes.CDLL(str(lib))
    return libs


def pack(p: dict) -> torch.Tensor:
    """The earlier design's (C, K) coefficient buffer (pack_weights
    order)."""
    C = p["matrix0"].shape[0]
    return torch.cat([p[n].reshape(C, -1) for _, n in
                      eb_kernel.param_slots(p)], dim=1).contiguous()


def earlier_readings(libs: dict) -> None:
    i, v = ctypes.c_int, ctypes.c_void_p
    for B, C in SHAPES:
        p = cs.eb_params_for(C, (3, 3, 3, 3), seed=100)
        z = torch.randn(B, C, device="cuda") * 4
        packed = pack(p)
        w = eb_kernel.widths(p)
        L = len(w) - 1
        kinds = []
        for l in range(L):
            kinds += ([1] * (w[l + 1] * w[l]) + [0] * w[l + 1]
                      + ([2] * w[l + 1] if l < L - 1 else []))
        kinds = torch.tensor(kinds, device="cuda")
        transformed = torch.where(kinds == 1, F.softplus(packed), torch.where(
            kinds == 2, torch.tanh(packed), packed)).contiguous()
        dims = (i * len(w))(*w)
        stream = torch.cuda.current_stream().cuda_stream
        want = eb_kernel.likelihood_plain(p, z)
        row = {}
        for (group, name), lib in libs.items():
            if group != "earlier":
                continue
            lib.lossyless_eb_likelihood.restype = i
            lib.lossyless_eb_likelihood.argtypes = [
                v, v, v, i, i, i, ctypes.POINTER(i), i, v]
            out = torch.empty_like(z)
            co = transformed if name == "chain_pretransformed" else packed
            fn = (lambda lib=lib, out=out, co=co: lib.lossyless_eb_likelihood(
                z.data_ptr(), co.data_ptr(), out.data_ptr(), B, C, L, dims,
                torch.cuda.current_device(), stream))
            if fn() != 0:
                raise RuntimeError(f"earlier design {name} did not launch")
            torch.cuda.synchronize()
            row[name] = dict(ms=cs.median_ms(fn), device_ms=cs.device_ms(
                fn, ("eb_likelihood_kernel",)))
            if name in ("full", "chain_pretransformed"):
                row[name]["max_abs_err"] = (out - want).abs().max().item()
        print(json.dumps({"earlier_design": dict(B=B, C=C, **row)}), flush=True)


def design_readings(libs: dict) -> None:
    i, v, n = ctypes.c_int, ctypes.c_void_p, ctypes.c_size_t
    for B, C in SHAPES:
        p = cs.eb_params_for(C, (3, 3, 3, 3), seed=100)
        z = torch.randn(B, C, device="cuda") * 4
        g = torch.randn(B, C, device="cuda")
        plan = eb_kernel.check_params(p, z)
        args = eb_kernel._args(p, plan)
        grads = {k: torch.empty_like(p[k]) for _, k in
                 eb_kernel.param_slots(p)}
        gargs = eb_kernel._args(p, plan, grads)
        stream = torch.cuda.current_stream().cuda_stream
        want = eb_kernel.likelihood_plain(p, z)
        out, dz = torch.empty_like(z), torch.empty_like(z)
        row = {}
        for (group, name), lib in libs.items():
            if group != "design":
                continue
            lib.lossyless_eb_init.restype = i
            lib.lossyless_eb_likelihood.restype = i
            lib.lossyless_eb_likelihood.argtypes = [
                v, v, i, i, i, i, n, eb_kernel._Args, v]
            lib.lossyless_eb_likelihood_bwd.restype = i
            lib.lossyless_eb_likelihood_bwd.argtypes = [
                v, v, v, i, i, i, i, n, eb_kernel._Args, v]
            if lib.lossyless_eb_init() != 0:
                raise RuntimeError(f"design {name}: init failed")

            def fwd(warps=eb_kernel.WARPS, lib=lib):
                return lib.lossyless_eb_likelihood(
                    z.data_ptr(), out.data_ptr(), B, C, plan.design_id,
                    warps * 32, plan.smem, args, stream)

            if fwd() != 0:
                raise RuntimeError(f"design {name} did not launch")
            torch.cuda.synchronize()
            row[name] = dict(ms=cs.median_ms(fwd), device_ms=cs.device_ms(
                fwd, ("eb_likelihood_kernel",)))
            if name in ("full", "local_table", "local_table_no_cluster"):
                row[name]["max_abs_err"] = (out - want).abs().max().item()
            if name != "full":
                continue
            lib.lossyless_eb_resident_clusters.restype = i
            lib.lossyless_eb_resident_clusters.argtypes = [i, i, i, n]
            row["clusters"] = plan.blocks // eb_kernel.SPLIT
            for warps in range(1, eb_kernel.WARPS + 1):
                for bwd, smem in ((0, plan.smem),
                                  (1, (1 + warps) * plan.smem)):
                    row[f"{('forward', 'backward')[bwd]}_warps_{warps}"
                        f"_resident_clusters"] = \
                        lib.lossyless_eb_resident_clusters(
                            plan.design_id, bwd, warps * 32, smem)
            for warps in range(1, eb_kernel.WARPS):
                row[f"forward_warps_{warps}_device_ms"] = cs.device_ms(
                    lambda: fwd(warps), ("eb_likelihood_kernel",))
            for warps in range(1, eb_kernel.WARPS + 1):
                smem = (1 + warps) * plan.smem
                for tag, a in (("", gargs), ("_dz_only", args)):
                    bwd = (lambda warps=warps, smem=smem, a=a:
                           lib.lossyless_eb_likelihood_bwd(
                               z.data_ptr(), g.data_ptr(), dz.data_ptr(), B,
                               C, plan.design_id, warps * 32, smem, a,
                               stream))
                    if bwd() != 0:
                        raise RuntimeError("the backward did not launch")
                    row[f"backward_warps_{warps}{tag}_device_ms"] = \
                        cs.device_ms(bwd, ("eb_likelihood_bwd_kernel",))
        print(json.dumps({"design": dict(
            B=B, C=C, plan_warps=plan.threads // 32,
            plan_bwd_warps=plan.bwd_threads // 32, **row)}), flush=True)


def step_kernels() -> None:
    from lossyless_tpu_torch.pipeline import config
    from lossyless_tpu_torch.pipeline.run import run_featurizer

    kernel_bwd = eb_kernel._launch_bwd
    presets = (("clip_hub", cs.TRAIN_OVERRIDES),
               ("clip_bottleneck_pretrain", ["rate.eb_use_pallas=True",
                                             "trainer.log_every=5"]))
    with tempfile.TemporaryDirectory() as tmp:
        for preset, overrides in presets:
            cfg = config.apply_overrides(config.preset(preset), overrides + [
                f"out_dir={tmp}/{preset}"])
            cfg.in_shape = (224, 224, 3)
            batches = cs.train_images(3, seed=7)
            state = run_featurizer(cfg, batches, total_steps=24,
                                   device="cuda", log=lambda _: None)
            result = {}
            for turn, backward in enumerate(("kernel", "eager", "eager",
                                             "kernel")):
                eb_kernel._launch_bwd = (kernel_bwd if backward == "kernel"
                                         else cs.k3_eager_backward)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    run_featurizer(cfg, batches, state=state,
                                   device="cuda", log=lambda _: None)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                ev = [e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
                result[f"turn{turn}_{backward}"] = dict(
                    device_kernels_per_step=sum(e.count for e in ev) / 3,
                    busy_ms_per_step=sum(e.self_device_time_total
                                         for e in ev) / 3e3,
                    wall_ms_per_step=wall / 3)
            eb_kernel._launch_bwd = kernel_bwd
            print(json.dumps({"step_kernels": dict(
                card=cs.card_line(), preset=preset, batch=cs.TRAIN_BATCH,
                **result)}), flush=True)
            del state


def main() -> int:
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    src = (ROOT / "lossyless_tpu_torch" / "coding" / "csrc"
           / "eb_likelihood.cu").read_text()
    libs = build_all({"earlier": earlier_variants(Path(sys.argv[1]).read_text()),
                      "design": design_variants(src)})
    earlier_readings(libs)
    design_readings(libs)
    step_kernels()
    return 0


if __name__ == "__main__":
    sys.exit(main())
