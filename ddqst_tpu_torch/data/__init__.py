"""Dataset building, record schema, and loaders for RQC tomography data."""

from ddqst_tpu_torch.data.generate import (  # noqa: F401
    build_dataset,
    build_dataset_chunked,
)
from ddqst_tpu_torch.data.loader import (  # noqa: F401
    counts_to_bits_exact,
    dataset_to_training_arrays,
)
from ddqst_tpu_torch.data.records import (  # noqa: F401
    CircuitRecord,
    load_dataset,
    load_shard,
    save_shard,
)
