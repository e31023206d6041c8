"""Question / answer templates shared by the segmentation datasets (the
port's own copy of videoglamm_tpu/data/datasets/templates.py)."""
from ...constants import DEFAULT_IMAGE_TOKEN, DEFAULT_VIDEO_TOKEN

VIDEO_QUESTION_LIST = [
    DEFAULT_VIDEO_TOKEN + "\n" + "Can you segment {phrase} in this video?",
    DEFAULT_VIDEO_TOKEN + "\n" + "Please locate {phrase} in this video.",
    DEFAULT_VIDEO_TOKEN + "\n" + "What is {phrase} in this video? Please "
                                 "respond with segmentation masks.",
    DEFAULT_VIDEO_TOKEN + "\n" + "Perform spatial segmentation of {phrase}",
]

IMAGE_QUESTION_LIST = [
    DEFAULT_IMAGE_TOKEN + "\n" + "Can you segment the {class_name} in this "
                                 "image?",
    DEFAULT_IMAGE_TOKEN + "\n" + "Please segment the {class_name} in this "
                                 "image.",
    DEFAULT_IMAGE_TOKEN + "\n" + "What is {class_name} in this image? "
                                 "Please respond with segmentation mask.",
    DEFAULT_IMAGE_TOKEN + "\n" + "What is {class_name} in this image? "
                                 "Please output segmentation mask.",
]

ANSWER_LIST = [
    "It is [SEG].",
    "Sure, [SEG].",
    "Sure, it is [SEG].",
    "Sure, the segmentation result is [SEG].",
    "[SEG].",
]

GCG_QUESTIONS = [
    DEFAULT_VIDEO_TOKEN + "\n" + "Could you please give me a detailed "
    "description of the video? Please respond with interleaved "
    "segmentation masks for the corresponding parts of the answer.",
]
