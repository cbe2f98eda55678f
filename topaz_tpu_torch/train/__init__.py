"""Picker training: objectives, crop sampling, augmentation, folds and the
train step (port of topaz_tpu/train/, 2D)."""
