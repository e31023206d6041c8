"""Token and preprocessing constants (the values of
videoglamm_tpu/constants.py that the port reads)."""

IGNORE_INDEX = -100          # label positions excluded from the CE loss
IMAGE_TOKEN_INDEX = -200     # placeholder id marking where visual tokens splice in
MASK_IGNORE_INDEX = -1       # padded mask pixels excluded from the dice/BCE loss

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
