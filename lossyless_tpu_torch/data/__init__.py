"""Datasets: the banana source, feature arrays, image datasets, the
external datasets and their ingestion."""

from .._lazy import exports

__all__, __getattr__, __dir__ = exports(__name__, {
    "BananaDataset": ".banana", "device_sample_batch": ".banana",
    "FeaturesDataset": ".features", "ImageDataset": ".images",
    "get_datamodule": ".images", "load_image_folder": ".images",
    "CocoClipDataset": ".external", "GalaxyZooDataset": ".external",
    "StreamingImageFolder": ".external", "ingest_tfds": ".ingest",
    "ingest_kaggle_galaxy": ".ingest", "ingest_coco_clip": ".ingest",
    "read_tfrecord": ".ingest", "write_tfrecord": ".ingest",
    "parse_tf_example": ".ingest"})
