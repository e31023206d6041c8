from .conversation import (Conversation, ConvGenerator, SeparatorStyle,
                           conv_templates, tokenizer_image_token)
from .preprocess import (preprocess_clip, preprocess_internvideo,
                         preprocess_sam2, sample_frame_indices)
from .collate import build_batch
from .prefetch import PrefetchIterator, prefetch_to_device
from .rle import rle_decode, rle_encode
from .augment import apply_sam_augmentations
