"""topaz denoise3d (topaz/commands/denoise3d.py): tomogram denoising and
noise2noise training on even/odd tomograms, with the JAX CLI's flags and
defaults but one: ``-d`` defaults to 0, not -2 (every device, via the device
mesh, which is not yet ported); on one card both run on that card."""
import argparse

from topaz_tpu_torch.device import parse_device_flag

name = "denoise3d"
help = "denoise 3D volumes with various denoising algorithms"


def add_arguments(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(help)

    parser.add_argument("volumes", nargs="*", help="volumes to denoise")
    parser.add_argument("-o", "--output", default="", help="directory to save denoised volumes")
    parser.add_argument("--suffix", default="", help='suffix for output file names; defaults to ".denoised" when no output directory is given (default: none)')
    parser.add_argument("-m", "--model", default="unet-3d", help="pretrained denoising model or path to a saved .npz model. pretrained options: unet-3d, unet-3d-10a, unet-3d-20a, whose weights are not bundled (default: unet-3d)")

    parser.add_argument("-a", "--even-train-path", help="path to even training data")
    parser.add_argument("-b", "--odd-train-path", help="path to odd training data")
    parser.add_argument("--N-train", type=int, default=1000, help="Number of train points per volume (default: 1000)")
    parser.add_argument("--N-test", type=int, default=200, help="Number of test points per volume (default: 200)")
    parser.add_argument("-c", "--crop", type=int, default=96, help="training tile size (default: 96)")
    parser.add_argument("--base-kernel-width", type=int, default=11, help="width of the base convolutional filter kernel in the U-net model (default: 11)")

    parser.add_argument("--optim", choices=["adam", "adagrad", "sgd"], default="adagrad", help="optimizer (default: adagrad)")
    parser.add_argument("--lr", default=0.001, type=float, help="learning rate for the optimizer (default: 0.001)")
    parser.add_argument("--criteria", default="L2", choices=["L1", "L2"], help="training criteria (default: L2)")
    parser.add_argument("--momentum", type=float, default=0.8, help="momentum parameter for SGD optimizer (compatibility flag: sgd runs with nesterov momentum 0.9, as in the JAX CLI) (default: 0.8)")
    parser.add_argument("--batch-size", type=int, default=10, help="minibatch size (default: 10)")
    parser.add_argument("--num-epochs", type=int, default=500, help="number of training epochs (default: 500)")
    parser.add_argument("-w", "--weight_decay", type=float, default=0, help="L2 regularizer on the generative network (default: 0)")
    parser.add_argument("--save-interval", default=10, type=int, help="save frequency in epochs (default: 10)")
    parser.add_argument("--save-prefix", help="path prefix to save denoising model")
    parser.add_argument("--num-workers", type=int, default=1, help="number of workers for data loading (compatibility flag)")
    parser.add_argument("-j", "--num-threads", type=int, default=0, help="number of host threads (compatibility flag)")

    parser.add_argument("-g", "--gaussian", type=float, default=0, help="standard deviation of Gaussian filter postprocessing, 0 means no postprocessing (default: 0)")
    parser.add_argument("-s", "--patch-size", type=int, default=96, help="denoises volumes in patches of this size. not used if <1 (default: 96)")
    parser.add_argument("--precision", choices=["f32", "bf16"], default="f32", help="inference precision: bf16 weights and activations with f32 statistics and output; f32 (TF32 off) keeps parity with the reference (default: f32)")
    parser.add_argument("--auto-patch", action="store_true", help="override -s with the patch size that processes the fewest voxels for each tomogram's dimensions (padded overlap plus grid overshoot)")
    parser.add_argument("-p", "--patch-padding", type=int, default=48, help="padding around each patch to remove edge artifacts (default: 48)")
    parser.add_argument("-d", "--device", type=parse_device_flag, default=0, help="CUDA device index, -1 for the current CUDA device, or cpu to run on the CPU; -2 (all devices) is not yet ported (default: 0)")

    from topaz_tpu_torch.cli.fast import add_fast_flag

    add_fast_flag(parser)
    return parser


def main(args):
    from topaz_tpu_torch.cli.fast import apply_fast
    from topaz_tpu_torch.denoise import denoise3d_main

    apply_fast(args)  # --fast -> --precision bf16
    if args.auto_patch:
        args.patch_size = -2  # per-tomogram auto patch size (Denoise3D.denoise)
    denoise3d_main(args)
