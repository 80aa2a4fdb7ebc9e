"""Offline ingestion: raw dataset files -> the on-disk layouts loaders read.

Counterpart of `lossyless_tpu/data/ingest.py`, host code that writes the
same files byte for byte:

* TFRecord framing with the masked CRC-32C, and a self-contained
  tf.Example wire-format parser and encoder (no tensorflow);
* `ingest_tfds`: tfds' on-disk TFRecord shards -> the class-per-subdir
  jpeg folders `<root>/<name>/<split>/<class>/<i>.jpeg` that
  `data.images.load_image_folder` reads;
* `ingest_kaggle_galaxy`: the Galaxy Zoo challenge tree -> per split
  `{i}th_img.jpeg` (centre crop, resize), `<split>_ids.npy` and
  `train_targets.npy` (the 37 regression tasks), which
  `data.external.GalaxyZooDataset` reads;
* `ingest_coco_clip`: COCO's images and `captions_*.json` -> per image
  `{i}th_img.jpeg` and `{i}th_features.npy` (the CLIP text features of
  its captions), which `data.external.CocoClipDataset` reads;
* `hash_tokenize`, a word-hash tokenizer in CLIP's id layout, and the
  default caption encoder: the port's CLIP text tower
  (`nn.clip_text.TextTransformer`) on the card, built once from a seeded
  generator and reused for every call.

The training path never calls these.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np

EXIST_DATA = "_exist_data.txt"  # sentinel name matching the reference


# ---------------------------------------------------------------------------
# TFRecord framing (pure python)
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _crc32c(data: bytes) -> int:
    """Software CRC-32C (Castagnoli), the checksum TFRecord uses."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC_TABLE = table
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return ((crc >> 15) | (crc << 17)) + 0xA282EAD8 & 0xFFFFFFFF


def read_tfrecord(path) -> "list[bytes]":
    """Yield raw record payloads from a TFRecord file, verifying CRCs."""
    with Path(path).open("rb") as f:
        while True:
            head = f.read(8)
            if not head:
                return
            if len(head) != 8:
                raise ValueError("truncated TFRecord length header")
            (length,) = struct.unpack("<Q", head)
            (len_crc,) = struct.unpack("<I", f.read(4))
            if _masked_crc(head) != len_crc:
                raise ValueError("TFRecord length CRC mismatch")
            data = f.read(length)
            if len(data) != length:
                raise ValueError("truncated TFRecord payload")
            (data_crc,) = struct.unpack("<I", f.read(4))
            if _masked_crc(data) != data_crc:
                raise ValueError("TFRecord payload CRC mismatch")
            yield data


def write_tfrecord(path, payloads) -> None:
    """Write raw payloads in TFRecord framing (for fixtures and tests)."""
    with Path(path).open("wb") as f:
        for data in payloads:
            head = struct.pack("<Q", len(data))
            f.write(head)
            f.write(struct.pack("<I", _masked_crc(head)))
            f.write(data)
            f.write(struct.pack("<I", _masked_crc(data)))


# ---------------------------------------------------------------------------
# Minimal protobuf wire format <-> tf.Example
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, i: int):
    out, shift = 0, 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value) over a message's fields."""
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:                       # varint
            val, i = _read_varint(buf, i)
        elif wire == 2:                     # length-delimited
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wire == 5:                     # fixed32
            val = buf[i:i + 4]
            i += 4
        elif wire == 1:                     # fixed64
            val = buf[i:i + 8]
            i += 8
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_feature(buf: bytes):
    """Feature{bytes_list=1 | float_list=2 | int64_list=3} -> python list."""
    for field, _, val in _iter_fields(buf):
        if field == 1:      # BytesList: repeated bytes value = 1
            return [v for f, _, v in _iter_fields(val) if f == 1]
        if field == 2:      # FloatList: repeated float value = 1 [packed]
            floats = []
            for f, wire, v in _iter_fields(val):
                if f != 1:
                    continue
                if wire == 2:  # packed
                    floats.extend(struct.unpack(f"<{len(v)//4}f", v))
                else:          # unpacked fixed32
                    floats.append(struct.unpack("<f", v)[0])
            return floats
        if field == 3:      # Int64List: repeated int64 value = 1 [packed]
            ints = []
            for f, wire, v in _iter_fields(val):
                if f != 1:
                    continue
                if wire == 2:  # packed varints
                    j = 0
                    while j < len(v):
                        x, j = _read_varint(v, j)
                        ints.append(x - (1 << 64) if x >= 1 << 63 else x)
                else:
                    ints.append(v - (1 << 64) if v >= 1 << 63 else v)
            return ints
    return []


def parse_tf_example(payload: bytes) -> dict:
    """tf.Example bytes -> {feature_name: list of bytes/float/int}."""
    features = {}
    for field, _, val in _iter_fields(payload):
        if field != 1:      # Example.features
            continue
        for f, _, entry in _iter_fields(val):
            if f != 1:      # Features.feature map entries
                continue
            key, feat = None, []
            for ef, _, ev in _iter_fields(entry):
                if ef == 1:
                    key = ev.decode("utf-8")
                elif ef == 2:
                    feat = _parse_feature(ev)
            if key is not None:
                features[key] = feat
    return features


def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        out.append(b | (0x80 if x else 0))
        if not x:
            return bytes(out)


def _field(num: int, payload: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(payload)) + payload


def encode_tf_example(features: dict) -> bytes:
    """{name: bytes|str|list[int]|list[float]} -> tf.Example bytes."""
    entries = b""
    for key, val in features.items():
        if isinstance(val, (bytes, str)):
            val = [val]
        if all(isinstance(v, (bytes, str)) for v in val):
            items = b"".join(_field(1, v.encode() if isinstance(v, str)
                                    else v) for v in val)
            feat = _field(1, items)                       # bytes_list
        elif all(isinstance(v, (int, np.integer)) for v in val):
            packed = b"".join(_varint(int(v) & (1 << 64) - 1) for v in val)
            feat = _field(3, _field(1, packed))           # int64_list packed
        else:
            packed = struct.pack(f"<{len(val)}f", *[float(v) for v in val])
            feat = _field(2, _field(1, packed))           # float_list packed
        entries += _field(1, _field(1, key.encode()) + _field(2, feat))
    return _field(1, entries)


# ---------------------------------------------------------------------------
# tfds shards -> class-per-subdir jpeg folders
# ---------------------------------------------------------------------------


def ingest_tfds(shard_paths, name: str, out_root, split: str,
                image_key: str = "image", label_key: str = "label",
                label_names=None, min_size: int | None = 256) -> Path:
    """Materialize tfds TFRecord shards as the folder layout loaders read.

    Matches the output contract of the reference's
    `TensorflowBaseDataset.download` (utils/data/images.py:803-841):
    `<out_root>/<name>/<split>/<label_name>/<i>.jpeg`, images resized so the
    short edge is `min_size`, plus an `_exist_data` sentinel.
    """
    from PIL import Image
    import io

    split_dir = Path(out_root) / name / split
    split_dir.mkdir(parents=True, exist_ok=True)
    i = 0
    for shard in shard_paths:
        for payload in read_tfrecord(shard):
            ex = parse_tf_example(payload)
            img_v = ex[image_key][0]
            if isinstance(img_v, bytes):
                img = Image.open(io.BytesIO(img_v)).convert("RGB")
            else:
                raise ValueError(f"{image_key} is not encoded image bytes")
            if min_size is not None:
                w, h = img.size
                scale = min_size / min(w, h)
                if scale != 1.0:
                    img = img.resize((max(1, round(w * scale)),
                                      max(1, round(h * scale))),
                                     Image.BICUBIC)
            label = int(ex[label_key][0])
            lname = label_names[label] if label_names else f"{label:04d}"
            lname = lname.replace(" ", "_").replace("/", "")
            ldir = split_dir / lname
            ldir.mkdir(exist_ok=True)
            img.save(ldir / f"{i}.jpeg")
            i += 1
    (split_dir / EXIST_DATA).touch()
    return split_dir


# ---------------------------------------------------------------------------
# kaggle galaxy-zoo -> regression layout
# ---------------------------------------------------------------------------


def ingest_kaggle_galaxy(raw_dir, out_root, resolution: int = 128,
                         crop: int = 256) -> Path:
    """Preprocess the raw galaxy-zoo challenge tree (already unzipped).

    Input (the kaggle archive contents, reference images.py:1185-1214):
    `images_training_rev1/<GalaxyID>.jpg`, `images_test_rev1/<id>.jpg`,
    `training_solutions_rev1.csv`. Output per split:
    `<out_root>/galaxy/<split>/{i}th_img.jpeg` (center-crop `crop` then
    resize to `resolution`), `<split>_ids.npy`, and `train_targets.npy`
    with the 37 regression tasks row-aligned to the image order.
    """
    from PIL import Image

    raw_dir = Path(raw_dir)
    out_dir = Path(out_root) / "galaxy"
    split_to_root = {"train": "images_training_rev1",
                     "test": "images_test_rev1"}

    solutions = {}
    csv_path = raw_dir / "training_solutions_rev1.csv"
    if csv_path.exists():
        with csv_path.open() as f:
            next(f)  # header
            for line in f:
                parts = line.strip().split(",")
                solutions[int(parts[0])] = np.asarray(parts[1:], np.float32)

    for split, sub in split_to_root.items():
        src = raw_dir / sub
        if not src.exists():
            continue
        split_dir = out_dir / split
        split_dir.mkdir(parents=True, exist_ok=True)
        paths = sorted(src.glob("*.jpg"))
        ids, targets = [], []
        for i, p in enumerate(paths):
            img = Image.open(p).convert("RGB")
            w, h = img.size
            side = min(crop, w, h)
            left, top = (w - side) // 2, (h - side) // 2
            img = img.crop((left, top, left + side, top + side))
            img = img.resize((resolution, resolution), Image.BICUBIC)
            img.save(split_dir / f"{i}th_img.jpeg")
            gid = int(p.stem)
            ids.append(gid)
            if split == "train":
                targets.append(solutions[gid])
        np.save(out_dir / f"{split}_ids.npy", np.asarray(ids, np.int64))
        if split == "train":
            np.save(out_dir / "train_targets.npy", np.stack(targets))
        (split_dir / EXIST_DATA).touch()
    return out_dir


# ---------------------------------------------------------------------------
# COCO captions -> (image, caption-features) layout
# ---------------------------------------------------------------------------


def ingest_coco_clip(coco_dir, out_root, split: str = "train",
                     text_encode_fn=None, size: int = 224,
                     limit: int | None = None, device=None) -> Path:
    """COCO captions -> `{i}th_img.jpeg` + `{i}th_features.npy` per image.

    Reference `CocoClipDataset.preprocess_split` (images.py:1297-1327)
    resizes each image and stores the CLIP text features of all its
    captions. Annotations are parsed from the plain `captions_<split>.json`
    (pycocotools not needed: the json has `images` and `annotations` keys).
    `text_encode_fn(list[str]) -> (n, 512)` defaults to the port's CLIP
    text tower (`_default_text_encoder`) on `device` with seeded random
    weights (the published ones are not in the repository; pass an encode
    fn over a converted state dict for real features).
    """
    from PIL import Image

    coco_dir = Path(coco_dir)
    split_root = {"train": "train2017", "test": "val2017"}[split]
    ann = {"train": "annotations/captions_train2017.json",
           "test": "annotations/captions_val2017.json"}[split]
    with (coco_dir / ann).open() as f:
        meta = json.load(f)

    captions: dict[int, list[str]] = {}
    for a in meta["annotations"]:
        captions.setdefault(a["image_id"], []).append(a["caption"])
    files = {img["id"]: img["file_name"] for img in meta["images"]}

    if text_encode_fn is None:
        text_encode_fn = _default_text_encoder(device)

    split_dir = Path(out_root) / "coco_captions" / split
    split_dir.mkdir(parents=True, exist_ok=True)
    img_ids = sorted(files)
    if limit is not None:
        img_ids = img_ids[:limit]
    for i, img_id in enumerate(img_ids):
        img = Image.open(coco_dir / split_root / files[img_id]).convert("RGB")
        img = img.resize((size, size), Image.BICUBIC)
        img.save(split_dir / f"{i}th_img.jpeg")
        feats = np.asarray(text_encode_fn(captions.get(img_id, [""])),
                           np.float32)
        np.save(split_dir / f"{i}th_features.npy", feats)
    (split_dir / EXIST_DATA).touch()
    return split_dir


def hash_tokenize(texts, context_length: int = 77,
                  vocab_size: int = 49408) -> np.ndarray:
    """Deterministic word-hash tokenizer in CLIP's id layout.

    The real BPE vocab ships with the CLIP weights (not downloadable here);
    this stand-in preserves the contract `nn.clip_text` expects — <start>
    (49406) + ids + <end> (49407) + zero padding, 77 wide — so the ingestion
    plumbing runs offline end-to-end. Swap in a real tokenizer alongside
    real weights for published-number parity.
    """
    import zlib

    sot, eot = vocab_size - 2, vocab_size - 1
    out = np.zeros((len(texts), context_length), np.int32)
    for r, text in enumerate(texts):
        ids = [zlib.crc32(w.encode()) % (vocab_size - 2)
               for w in text.lower().split()][:context_length - 2]
        row = [sot] + ids + [eot]
        out[r, :len(row)] = row
    return out


def _default_text_encoder(device=None, model=None):
    """`encode(list[str]) -> (n, out_dim)` fp32 numpy: `hash_tokenize`,
    then CLIP's text tower on `device` (the card unless given). The tower
    (`model`, else `TextTransformer` at CLIP's sizes initialised from a
    generator seeded with 0) is built once and serves every call."""
    import torch

    from ..core.device import resolve_device
    from ..nn.clip_text import TextTransformer

    device = resolve_device(device)
    if model is None:
        model = TextTransformer(generator=torch.Generator().manual_seed(0))
    model = model.to(device).eval()

    @torch.no_grad()
    def encode(texts):
        tokens = torch.as_tensor(hash_tokenize(texts), dtype=torch.long,
                                 device=device)
        return model(tokens).float().cpu().numpy()

    return encode
