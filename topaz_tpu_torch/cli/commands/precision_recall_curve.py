"""topaz precision_recall_curve (topaz/commands/precision_recall_curve.py):
the precision-recall curve of scored picks against target coordinates, on
the host, with the JAX CLI's flags and output."""
import argparse

name = "precision_recall_curve"
help = ("calculate the precision-recall curve for a set of predicted particle "
        "coordinates with scores and a set of target coordinates")


def add_arguments(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(help)
    parser.add_argument("--predicted", help="path to file containing predicted particle coordinates with scores")
    parser.add_argument("--targets", help="path to file specifying target particle coordinates")
    parser.add_argument("-r", "--assignment-radius", required=True, type=int, help="maximum distance between prediction and labeled target allowed for considering them a match")
    parser.add_argument("--images", choices=["target", "predicted", "union"], default="target", help="which micrographs to count particles on (default: target)")
    return parser


def main(args):
    from topaz_tpu_torch.ops.metrics import particle_prc

    particle_prc(args.targets, args.predicted, args.assignment_radius, args.images)
