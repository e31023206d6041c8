from .train_step import (TRAINABLE_PATTERNS, AdamW, Training, TrainState,
                         build_training, create_train_state, lr_schedule,
                         make_optimizer, make_train_step, trainable_mask)
