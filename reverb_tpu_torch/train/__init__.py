"""Training of the hybrid CTC/attention model: schedules, the train and
eval steps (Adam, clipping, non-finite skip, freeze rules), checkpoints,
the executor's epoch loop and the stall watchdog (counterpart of
reverb_tpu/train/)."""
