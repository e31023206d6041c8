from .templates import (ANSWER_LIST, GCG_QUESTIONS, IMAGE_QUESTION_LIST,
                        VIDEO_QUESTION_LIST)
from .base import DatasetSpec, HybridDataset, SampleBuilder
from .video_gcg import GCGVideoDataset, build_gcg_caption
from .refer_vos import ReferVOSDataset
from .reason_seg import ReasonSegDataset, get_mask_from_json
from .sem_seg import SemSegDataset
from .vqa import VQADataset
from .grounding_extra import (GCGFromExpressions, GranDfDataset,
                              TemporalGroundingDataset, VidSTGDataset)
from .refer_seg import ReferSegDataset, decode_segmentation
from .grounded_video_qa import GroundedVideoQADataset, normalize_seg_answer
from .sem_seg import (CocoPartSegDataset, load_cocostuff_classes,
                      load_mapillary_classes)
from .video_gcg_extra import (ANetEntitiesGCGDataset, ConcatDataset,
                              VidSTGHCSTVGGCGDataset, build_val_gcg)
from .refer_eval import (A2DSentencesDataset, JHMDBSentencesDataset,
                         ReferSentencesTrainDataset)
