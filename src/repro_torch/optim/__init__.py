from .adamw import (AdamWConfig, adamw_init, adamw_update,
                    cosine_schedule, global_norm)
from .compress import (bf16_compress, error_feedback_int8_decode,
                       error_feedback_int8_encode)
