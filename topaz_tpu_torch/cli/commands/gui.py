"""topaz gui (topaz/commands/gui.py): opens the port's copy of the bundled
annotator (topaz_tpu_torch/gui/topaz_tpu_gui.html) in a web browser;
``TOPAZ_GUI_PATH`` points it at another file."""
import argparse
import os
import sys

name = "gui"
help = "opens the topaz GUI in a web browser"

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_GUI_PATH = os.environ.get(
    "TOPAZ_GUI_PATH", os.path.join(_PKG, "gui", "topaz_tpu_gui.html"))


def add_arguments(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(help)
    return parser


def main(args):
    import webbrowser

    path = DEFAULT_GUI_PATH
    if not path or not os.path.exists(path):
        print("ERROR: GUI asset not found. Set TOPAZ_GUI_PATH to the "
              "location of topaz.html (a VIA 2.x based annotator).",
              file=sys.stderr)
        sys.exit(1)
    webbrowser.open("file://" + os.path.realpath(path), new=2)
