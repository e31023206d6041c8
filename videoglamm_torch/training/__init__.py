from .train_step import (TRAINABLE_PATTERNS, AdamW, StateSharding, Training,
                         TrainState, build_training, create_train_state,
                         lr_schedule, make_optimizer, make_sharded_train_step,
                         make_train_step, opt_state_partition_spec,
                         split_batch, trainable_mask)
