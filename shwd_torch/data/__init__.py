"""Data pipeline: mesh/synthetic clouds + on-device rigid-transform batches."""

from .transforms import (  # noqa: F401
    TransformConfig, RegistrationBatch, random_pose_7d, apply_pose,
    make_registration_batch,
)
from .modelnet import (  # noqa: F401
    read_off, sample_mesh_points, normalize_scale, preprocess_modelnet,
    load_dataset,
)
from .synthetic import shape_bank  # noqa: F401
from .dataset import DatasetConfig, RegistrationDataset  # noqa: F401
