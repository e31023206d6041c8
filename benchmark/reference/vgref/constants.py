"""Token, data and preprocessing constants (the values of
videoglamm_tpu/constants.py that the port reads)."""
import os

# --- video chunking (InternVideo2 consumes 4-frame tubes) ---
CHUNK_SIZE = 4
NUM_FRAMES = int(os.environ.get("NUM_FRAMES", 16))
NUM_CONTEXT_IMAGES = int(os.environ.get("NUM_CONTEXT_IMAGES", 16))

# --- token-level constants ---
IGNORE_INDEX = -100          # label positions excluded from the CE loss
IMAGE_TOKEN_INDEX = -200     # placeholder id marking where visual tokens splice in
DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_VIDEO_TOKEN = "<video>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
DEFAULT_VID_START_TOKEN = "<vid_start>"
DEFAULT_VID_END_TOKEN = "<vid_end>"
SEG_TOKEN = "[SEG]"

# --- mask padding ---
MASK_IGNORE_INDEX = -1       # padded mask pixels excluded from the dice/BCE loss
MAX_NUM_SEG_TOKENS_PER_SAMPLE = 4

# --- canonical image sizes ---
INTERNVIDEO_IMAGE_SIZE = 224
CLIP_IMAGE_SIZE = 336
SAM_IMAGE_SIZE = 1024

# --- normalization of the three encoder streams ---
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
SAM_PIXEL_MEAN = (123.675, 116.28, 103.53)
SAM_PIXEL_STD = (58.395, 57.12, 57.375)
