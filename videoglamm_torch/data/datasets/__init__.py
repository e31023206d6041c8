from .templates import (ANSWER_LIST, GCG_QUESTIONS, IMAGE_QUESTION_LIST,
                        VIDEO_QUESTION_LIST)
from .base import DatasetSpec, HybridDataset, SampleBuilder
from .video_gcg import GCGVideoDataset, build_gcg_caption
from .refer_vos import ReferVOSDataset
from .reason_seg import ReasonSegDataset, get_mask_from_json
from .vqa import VQADataset
from .refer_eval import (A2DSentencesDataset, JHMDBSentencesDataset,
                         ReferSentencesTrainDataset)
