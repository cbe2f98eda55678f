"""topaz preprocess - alias of normalize (topaz/commands/preprocess.py)."""
from topaz_tpu_torch.cli.commands.normalize import add_arguments, main  # noqa: F401

name = "preprocess"
help = "downsample and normalize micrographs"
