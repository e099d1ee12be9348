"""Training of the hybrid CTC/attention model: schedules, the train step
(Adam, clipping, non-finite skip, freeze rules) and checkpoints
(counterpart of reverb_tpu/train/)."""
