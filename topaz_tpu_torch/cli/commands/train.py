"""topaz train (topaz/commands/train.py): PU picker training on micrographs
or tomograms (--dims 3, --augment-3d), with the autoencoder regularizer
(--autoencoder), with the JAX CLI's flags and defaults. The paths this port
does not run yet exit with a not-yet-ported error naming their ROADMAP item:
-d -2 (P14) and a .sav --model (P13)."""
import argparse

from topaz_tpu_torch.device import parse_device_flag

name = "train"
help = "train region classifier from images with labeled coordinates"


def add_arguments(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(help)

    parser.add_argument("--describe", action="store_true", help="only prints a description of the model, does not train")
    parser.add_argument("-d", "--device", default=0, type=parse_device_flag, help="CUDA device index, -1 for the current CUDA device, or cpu to run on the CPU; -2 (all devices) is not yet ported (default: 0)")
    parser.add_argument("--num-workers", default=0, type=int, help="number of worker processes for data augmentation (compatibility flag)")
    parser.add_argument("-j", "--num-threads", type=int, default=0, help="number of host threads (compatibility flag)")

    data = parser.add_argument_group("training data arguments (required)")
    data.add_argument("--train-images", help="path to file listing the training images. also accepts directory path from which all images are loaded.")
    data.add_argument("--train-targets", help="path to file listing the training particle coordinates")

    data = parser.add_argument_group("test data arguments (optional)")
    data.add_argument("--test-images", help="path to file listing the test images. also accepts directory path from which all images are loaded.")
    data.add_argument("--test-targets", help="path to file listing the testing particle coordinates.")

    data = parser.add_argument_group("data format arguments (optional)")
    data.add_argument("--format", dest="format_", choices=["auto", "coord", "csv", "star", "box"], default="auto", help="file format of the particle coordinates file (default: auto)")
    data.add_argument("--image-ext", default="", help='image extension when loading images from directory, including "." (default: find all extensions)')

    data = parser.add_argument_group("cross validation arguments (optional)")
    data.add_argument("-k", "--k-fold", default=0, type=int, help="option to split the training set into K folds for cross validation (default: not used)")
    data.add_argument("--fold", default=0, type=int, help="which fold is used as the heldout test set (default: 0)")
    data.add_argument("--cross-validation-seed", default=42, type=int, help="random seed for partitioning data into folds (default: 42)")

    training = parser.add_argument_group("training arguments (required)")
    training.add_argument("-n", "--num-particles", type=float, default=-1, help="expected number of particles per micrograph (>0), used to set pi. either this or pi must be set.")
    training.add_argument("--pi", type=float, help="parameter specifying fraction of data that is expected to be positive")

    training = parser.add_argument_group("training arguments (optional)")
    training.add_argument("-r", "--radius", default=3, type=int, help="pixel radius around particle centers to consider positive (default: 3)")
    training.add_argument("--method", choices=["PN", "GE-KL", "GE-binomial", "PU"], default="GE-binomial", help="objective function to use for learning the region classifier (default: GE-binomial)")
    training.add_argument("--slack", default=-1, type=float, help="weight on GE penalty (default: 10 for GE-KL, 1 for GE-binomial)")
    training.add_argument("--entropy-penalty", default=0.0, type=float, help="weight of the classifier-entropy penalty for the GE methods (reference hardcodes 0; topaz/methods.py:80,171)")
    training.add_argument("--ge-momentum", default=1.0, type=float, help="running-expectation momentum for GE-KL; 1 disables the running average (reference hardcodes 1.0; topaz/methods.py:170,210-212)")
    training.add_argument("--pu-beta", default=0.0, type=float, help="nnPU clipping threshold beta for the PU method; 0 is NNPU (reference hardcodes 0; topaz/methods.py:260-261)")
    training.add_argument("--autoencoder", default=0, type=float, help="option to augment method with autoencoder. weight on reconstruction error; 2D only (default: 0)")
    training.add_argument("--l2", default=0.0, type=float, help="l2 regularizer on the model parameters (default: 0)")
    training.add_argument("--learning-rate", default=0.0002, type=float, help="learning rate for the optimizer (default: 0.0002)")
    training.add_argument("--natural", action="store_true", help="sample unbiasedly from the data to form minibatches rather than balancing positives")
    training.add_argument("--minibatch-size", default=256, type=int, help="number of data points per minibatch (default: 256)")
    training.add_argument("--minibatch-balance", default=0.0625, type=float, help="fraction of minibatch that is positive data points (default: 0.0625)")
    training.add_argument("--epoch-size", default=1000, type=int, help="number of parameter updates per epoch (default: 1000)")
    training.add_argument("--num-epochs", default=10, type=int, help="maximum number of training epochs (default: 10)")
    training.add_argument("--augment-3d", dest="augment3d", action="store_true", help="augment 3D (--dims 3) training crops on the device: xy-plane rotation about z plus random x/y/z flips, the missing-wedge-safe group (extension: the reference never augments 3D crops)")

    model = parser.add_argument_group("model arguments (optional)")
    model.add_argument("--pretrained", dest="pretrained", action="store_true", help="initialize model parameters from the pretrained model with the same configuration when available (default)")
    model.add_argument("--no-pretrained", dest="pretrained", action="store_false")
    model.set_defaults(pretrained=True)
    model.add_argument("-m", "--model", default="resnet8", help="model type to fit, or an .npz checkpoint to go on from (default: resnet8)")
    model.add_argument("--units", default=32, type=int, help="number of units model parameter (default: 32)")
    model.add_argument("--dropout", default=0.0, type=float, help="dropout rate model parameter (default: 0.0)")
    model.add_argument("--bn", default="on", choices=["on", "off"], help="use batch norm in the model (default: on)")
    model.add_argument("--pooling", help="pooling method to use (default: none)")
    model.add_argument("--unit-scaling", default=2, type=int, help="scale the number of units by this factor every pool/stride layer (default: 2)")
    model.add_argument("--ngf", default=32, type=int, help="scaled number of units per layer in generative model, only used if autoencoder > 0 (default: 32)")
    model.add_argument("-s", "--patch-size", type=int, default=96, help="classify micrographs in patches of this size. not used if < 1 (default: 96)")
    model.add_argument("-p", "--patch-padding", type=int, default=48, help="padding around each patch to remove edge artifacts (default: 48)")

    outputs = parser.add_argument_group("output file arguments (optional)")
    outputs.add_argument("--save-prefix", help="path prefix to save trained models each epoch")
    outputs.add_argument("--resume", help="path to a <save-prefix>_train_state.npz checkpoint: restore the whole training state (optimizer, method state, rng, sampler stream) and continue bit-exactly; a state written by the JAX package (python -m topaz_tpu train) restores all but its step key, so dropout and on-device augmentation then draw from --seed")
    outputs.add_argument("--save-interval-steps", type=int, default=0, help="also checkpoint the full training state every N steps within an epoch (0 = per-epoch only); mid-epoch resume continues on the exact next batch (default: 0)")
    outputs.add_argument("-o", "--output", help="destination to write the train/test curve")

    misc = parser.add_argument_group("miscellaneous arguments (optional)")
    misc.add_argument("--test-batch-size", default=1, type=int, help="batch size for calculating test set statistics (default: 1)")
    misc.add_argument("--seed", default=0, type=int, help="random seed for model init and sampling (default: 0)")
    misc.add_argument("--dims", type=int, default=2, choices=[2, 3], help="input dimensionality: 2 for micrographs, 3 to train a picker on tomograms with z_coord targets; the bundled pretrained pickers are 2D, so a 3D run starts from fresh weights (default: 2)")

    return parser


def main(args):
    from topaz_tpu_torch.training import train_from_args

    train_from_args(args)
