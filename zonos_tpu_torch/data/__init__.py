"""Training data pipeline (zonos_tpu/data/): datasets, the DAC-code cache,
the prefetching loader; it feeds ``zonos_tpu_torch/parallel/train.py``."""

from zonos_tpu_torch.data.dataset import (
    CodesCache,
    PreparedExample,
    TrainExample,
    prepare_examples,
    read_manifest,
    scan_dir,
    scan_ljspeech,
    total_audio_seconds,
)
from zonos_tpu_torch.data.loader import (
    BatchSpec,
    PrefetchLoader,
    assemble_batch,
    iter_epoch_batches,
)

__all__ = [
    "BatchSpec",
    "CodesCache",
    "PrefetchLoader",
    "PreparedExample",
    "TrainExample",
    "assemble_batch",
    "iter_epoch_batches",
    "prepare_examples",
    "read_manifest",
    "scan_dir",
    "scan_ljspeech",
    "total_audio_seconds",
]
