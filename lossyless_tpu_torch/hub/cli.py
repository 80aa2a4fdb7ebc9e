"""Deployment CLI: compress image datasets into bitstreams from the shell.

Counterpart of `lossyless_tpu/hub/cli.py`, with the same subcommands,
flags and printed lines:

    # folder of images (class subfolders -> labels) or a flat folder
    python -m lossyless_tpu_torch.hub.cli compress data/stl10_test out.bin \
        --beta b005 --labels out_labels.npy

    # .npz with arrays x (N,H,W,3 uint8) [+ y]
    python -m lossyless_tpu_torch.hub.cli compress images.npz out.bin

    # decode back to (N, 512) CLIP-space features
    python -m lossyless_tpu_torch.hub.cli decompress out.bin features.npz \
        --labels out_labels.npy

    # LinearSVC probe on decoded features (sklearn)
    python -m lossyless_tpu_torch.hub.cli eval train.npz test.npz

    # stream stats without touching the card
    python -m lossyless_tpu_torch.hub.cli info out.bin

Images of mixed sizes go through the host-side reference transform
(`nn.vit.pil_clip_preprocess`); uniform-size uint8 batches can instead have
resize and normalize run on the card with `--device-preprocess H W`.
`--clip-weights` loads an OpenAI CLIP torch checkpoint through
`convert_openai_clip_weights`; without it the tower is randomly
initialized (features are then not CLIP embeddings). `--beta` names a
published rate model (`hub/load_reference.py`). The compressor runs on the
card unless `--device` names another device; `--mesh N` encodes over N
cards (`ClipCompressor(mesh=...)`), with the same streams.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

IMAGE_SUFFIXES = (".jpg", ".jpeg", ".png", ".webp", ".bmp")
_DTYPES = ("bfloat16", "float32")


def _iter_folder(root: Path):
    """Yield (path, label|None) pairs; class subfolders define labels."""
    classes = sorted(d.name for d in root.iterdir() if d.is_dir())
    if classes:
        for label, cname in enumerate(classes):
            for p in sorted((root / cname).rglob("*")):
                if p.suffix.lower() in IMAGE_SUFFIXES:
                    yield p, label
    else:
        for p in sorted(root.iterdir()):
            if p.suffix.lower() in IMAGE_SUFFIXES:
                yield p, None


def _labels_or_none(labels):
    return None if any(l is None for l in labels) else np.asarray(labels)


def _folder_batches(root: Path, batch_size: int, preprocess):
    """Folder batches, decoded one batch ahead on a background thread
    (`data.loader.prefetch`) so the card never waits on JPEG decode; the
    same bytes as an inline loop."""
    from ..data.loader import prefetch

    def gen():
        from PIL import Image

        imgs, labels = [], []
        for path, label in _iter_folder(root):
            imgs.append(Image.open(path))  # lazy: decoded in the pool
            labels.append(label)
            if len(imgs) == batch_size:
                yield preprocess(imgs), _labels_or_none(labels)
                imgs, labels = [], []
        if imgs:
            yield preprocess(imgs), _labels_or_none(labels)

    return prefetch(gen())


def _npz_batches(path: Path, batch_size: int, preprocess):
    data = np.load(path, allow_pickle=False)
    if "x" not in data:
        raise SystemExit(f"{path}: .npz input needs an 'x' array "
                         f"(found {sorted(data.files)})")
    x, y = data["x"], data.get("y")
    for i in range(0, len(x), batch_size):
        xb = x[i:i + batch_size]
        yield preprocess(xb), (y[i:i + batch_size] if y is not None else None)


def _build_compressor(args):
    import torch

    from .compressor import load_pretrained

    dtype = getattr(torch, args.dtype)
    clip_sd = None
    if args.clip_weights:
        clip_sd = torch.load(args.clip_weights, map_location="cpu",
                             weights_only=False)
        if isinstance(clip_sd, dict) and "state_dict" in clip_sd:
            clip_sd = clip_sd["state_dict"]
    kwargs = {"device": args.device}
    if getattr(args, "mesh", 0):
        # N CUDA devices, or N replicas on the CPU with --device cpu
        from ..core.mesh import make_mesh

        kwargs["mesh"] = (make_mesh(devices=["cpu"] * args.mesh)
                          if args.device == "cpu" else make_mesh(args.mesh))
    if args.arch == "tiny":
        # smoke-test tower (512-d output so the published rate weights fit)
        from ..nn.vit import VisionTransformer

        kwargs["model"] = VisionTransformer(width=64, layers=2, heads=2,
                                            out_dim=512, dtype=dtype)
    if getattr(args, "device_preprocess", None):
        kwargs["raw_input_hw"] = tuple(args.device_preprocess)
    if getattr(args, "table_arithmetic", None):
        kwargs["table_arithmetic"] = args.table_arithmetic
    return load_pretrained(args.beta, clip_state_dict=clip_sd, dtype=dtype,
                           **kwargs)


def cmd_compress(args) -> int:
    if args.jpeg_draft:
        # the other input paths never decode-and-resize JPEGs on the host
        if args.device_preprocess:
            raise SystemExit("--jpeg-draft has no effect with "
                             "--device-preprocess (images are sent at "
                             "native size; resizing happens on device)")
        if Path(args.input).suffix == ".npz":
            raise SystemExit("--jpeg-draft has no effect on .npz input "
                             "(already-decoded arrays)")
    comp = _build_compressor(args)
    src = Path(args.input)

    if args.device_preprocess:
        # raw uint8 batches cross to the card, which resizes and
        # normalizes them (uniform source size required)
        def preprocess(imgs):
            return np.stack([np.asarray(im, np.uint8) for im in imgs]) \
                if isinstance(imgs, list) else np.asarray(imgs, np.uint8)
    else:
        from ..nn.vit import pil_clip_preprocess

        def preprocess(imgs):
            # without the flag the decode reads LOSSYLESS_JPEG_DRAFT
            return pil_clip_preprocess(imgs, draft=args.jpeg_draft or None)

    if src.is_dir():
        batches = _folder_batches(src, args.batch_size, preprocess)
    elif src.suffix == ".npz":
        batches = _npz_batches(src, args.batch_size, preprocess)
    else:
        raise SystemExit(f"{src}: expected an image folder or a .npz")

    rate, img_per_sec = comp.compress_dataset(
        batches, args.output, label_file=args.labels, is_info=False)
    print(f"Rate: {rate:.2f} bits/img | Encoding: {img_per_sec:.2f} img/sec")
    return 0


def cmd_decompress(args) -> int:
    comp = _build_compressor(args)
    out = comp.decompress_dataset(args.input, label_file=args.labels,
                                  is_info=False, batch_size=args.batch_size)
    z_hat, y = out if isinstance(out, tuple) else (out, None)
    arrays = {"z": z_hat}
    if y is not None:
        arrays["y"] = y
    np.savez(args.output, **arrays)
    print(f"Decoded {len(z_hat)} x {z_hat.shape[-1]}-d features "
          f"-> {args.output}")
    return 0


def cmd_eval(args) -> int:
    """LinearSVC probe on decompressed features (the reference's
    downstream STL10 evaluation)."""
    from ..analysis.linear_eval import z_linear_eval

    def load(path):
        d = np.load(path, allow_pickle=False)
        if "z" not in d or "y" not in d:
            raise SystemExit(f"{path}: need arrays z and y "
                             f"(from `decompress --labels ...`)")
        return d["z"], d["y"]

    z_tr, y_tr = load(args.train)
    z_te, y_te = load(args.test)
    t0 = time.time()
    out = z_linear_eval(z_tr, y_tr, z_te, y_te, n_iter=args.n_iter,
                        fixed_C=args.C)
    print(f"Accuracy: {100 * out['acc']:.2f}% | "
          f"Training time: {time.time() - t0:.1f} sec | "
          f"C: {out['best_C']:.4g}")
    return 0


def cmd_info(args) -> int:
    from ..coding.bitstream import read_dataset

    n, total = 0, 0
    for s in read_dataset(args.input):
        n += 1
        total += len(s)
    file_bits = 8 * Path(args.input).stat().st_size
    print(f"{args.input}: {n} images, "
          f"{8 * total / max(1, n):.2f} payload bits/img, "
          f"{file_bits / max(1, n):.2f} file bits/img")
    return 0


def _add_model_flags(p):
    p.add_argument("--beta", default="b005",
                   choices=("b001", "b005", "b01"),
                   help="published rate model (b01 compresses most)")
    p.add_argument("--clip-weights", default=None,
                   help="OpenAI CLIP torch checkpoint (.pt) for the tower")
    p.add_argument("--dtype", default="bfloat16", choices=_DTYPES,
                   help="tower compute dtype")
    p.add_argument("--arch", default="vit_b32", choices=("vit_b32", "tiny"),
                   help="tiny = 2-layer smoke-test tower")
    p.add_argument("--table-arithmetic", default="compressai",
                   choices=("compressai", "float64"),
                   help="CDF-table float pipeline. The stream format has no "
                        "arithmetic marker, so sender and receiver MUST use "
                        "the same value; 'compressai' cross-decodes with the "
                        "reference hub")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="lossyless_tpu_torch.hub.cli",
                                     description=__doc__.split("\n\n")[0])
    sub = parser.add_subparsers(dest="cmd", required=True)

    pc = sub.add_parser("compress", help="images -> dataset bitstream")
    pc.add_argument("input", help="image folder or .npz with x [, y]")
    pc.add_argument("output", help="output bitstream file")
    pc.add_argument("--labels", default=None,
                    help="also write labels to this .npy")
    pc.add_argument("--batch-size", type=int, default=256)
    pc.add_argument("--device-preprocess", type=int, nargs=2, default=None,
                    metavar=("H", "W"),
                    help="inputs are uniform raw uint8 HxW; resize and "
                         "normalize on the card")
    pc.add_argument("--jpeg-draft", action="store_true",
                    help="decode JPEGs larger than the input size at a "
                         "reduced DCT scale (libjpeg scaled decode; "
                         "slightly different pixels than full-resolution "
                         "decode)")
    pc.add_argument("--mesh", type=int, default=0,
                    help="shard encode batches over N cards (N CPU "
                         "replicas with --device cpu; 0 = one device); "
                         "streams are identical for any mesh size")
    _add_model_flags(pc)
    pc.set_defaults(fn=cmd_compress)

    pd = sub.add_parser("decompress", help="bitstream -> features .npz")
    pd.add_argument("input", help="dataset bitstream file")
    pd.add_argument("output", help="output .npz (z [, y])")
    pd.add_argument("--labels", default=None,
                    help="labels .npy written by compress")
    pd.add_argument("--batch-size", type=int, default=1024)
    _add_model_flags(pd)
    pd.set_defaults(fn=cmd_decompress)

    pe = sub.add_parser("eval", help="LinearSVC probe on decoded features")
    pe.add_argument("train", help=".npz with z, y (decompress --labels)")
    pe.add_argument("test", help=".npz with z, y")
    pe.add_argument("--n-iter", type=int, default=8,
                    help="RandomizedSearchCV iterations over C/class_weight")
    pe.add_argument("--C", type=float, default=None,
                    help="skip the search, use this LinearSVC C")
    pe.set_defaults(fn=cmd_eval)

    pi = sub.add_parser("info", help="stream stats (no card)")
    pi.add_argument("input")
    pi.set_defaults(fn=cmd_info)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
