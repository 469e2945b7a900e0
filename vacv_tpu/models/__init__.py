from .pipeline import (
    PreprocessConfig,
    Preprocessor,
    preprocess_fused_batch,
    preprocess_fused_nv_batch,
    slam_frontend_config,
)
from .serving import StreamExecutor, stream_map
