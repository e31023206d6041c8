from .metrics import (AverageMeter, boundary_f_measure, compute_iou,
                      compute_miou, davis_j, db_statistics,
                      find_best_matches, intersection_and_union,
                      masks_to_boxes, np_box_iou, temporal_iou, video_iou)
from .postprocess import (clean_caption, extract_phrases,
                          masks_to_original_size, remove_small_blobs,
                          seg2bmap)
from .clair import clair_metric, clair_score
