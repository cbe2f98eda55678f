"""Training: the picker's objectives, crop sampling, augmentation, folds and
train step, and the denoisers' paired-image and tomogram-tile samplers
(port of topaz_tpu/train/)."""
