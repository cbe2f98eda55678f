"""The port's CLI commands, one module each."""

import importlib

COMMANDS = (
    "boxes_to_coordinates", "convert", "coordinates_to_boxes", "coordinates_to_eman2_json",
    "coordinates_to_star", "denoise", "denoise3d", "downsample", "extract", "gui",
    "normalize", "particle_stack", "precision_recall_curve", "preprocess",
    "scale_coordinates", "segment", "serve", "split", "star_particles_threshold",
    "star_to_coordinates", "train", "train_test_split", "warmup", "watch",
)


def load():
    """The command modules, in name order."""
    return [importlib.import_module(f"{__name__}.{name}") for name in COMMANDS]
