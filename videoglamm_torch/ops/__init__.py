from .attention import dot_product_attention, flash_attention
from .norms import layer_norm, rms_norm
