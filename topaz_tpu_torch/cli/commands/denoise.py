"""topaz denoise (topaz/commands/denoise.py): 2D micrograph denoising and
noise2noise training (-a/-b or --hdf) with the JAX CLI's flags. -d -2
denoises each micrograph whole, split by rows over every CUDA device, and
splits training batches over them; --method, --preload and --num-workers
are compatibility flags, as in the JAX CLI."""
import argparse

from topaz_tpu_torch.device import parse_device_flag

name = "denoise"
help = "denoise micrographs with various denoising algorithms"


def add_arguments(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(help)

    parser.add_argument("-d", "--device", default=0, type=parse_device_flag, help="CUDA device index, -1 for the current CUDA device, -2 to denoise whole micrographs split over every CUDA device, or cpu to run on the CPU (default: 0)")
    parser.add_argument("micrographs", nargs="*", help="micrographs to denoise")
    parser.add_argument("-o", "--output", default="", help="directory to save denoised micrographs")
    parser.add_argument("--suffix", default="", help='suffix for output file names; defaults to ".denoised" when no output directory is given (default: none)')
    parser.add_argument("--format", dest="format_", default="mrc", help="output format for the images (default: mrc)")
    parser.add_argument("--normalize", action="store_true", help="normalize the micrographs")
    parser.add_argument("--stack", action="store_true", help="denoise a MRC stack rather than list of micrographs")
    parser.add_argument("--save-prefix", help="path prefix to save denoising model")
    parser.add_argument("--save-interval", default=10, type=int, help="save frequency in epochs (default: 10)")
    parser.add_argument("-m", "--model", nargs="+", default=["unet"], help="pretrained denoising model(s) or .npz checkpoint(s); multiple models are averaged. options: unet, unet-small, fcnn, affine, unet-v0.2.1 (default: unet)")

    parser.add_argument("-a", "--dir-a", help="directory of training images part A")
    parser.add_argument("-b", "--dir-b", help="directory of training images part B")
    parser.add_argument("--hdf", help="path to HDF5 file containing training image stack as an alternative to dirA/dirB")
    parser.add_argument("--preload", action="store_true", help="preload micrographs into RAM (compatibility flag)")
    parser.add_argument("--holdout", type=float, default=0.1, help="fraction of training micrograph pairs to holdout for validation (default: 0.1)")

    parser.add_argument("--downsample", type=int, default=1, help="Fourier-crop micrographs by this factor and denoise at the reduced (picking) scale, factor^2 less U-Net work; output is downsampled (default: 1, full resolution)")
    parser.add_argument("--lowpass", type=float, default=1, help="lowpass filter micrographs by this amount (in pixels) before denoising (default: no lowpass filtering)")
    parser.add_argument("--gaussian", type=float, default=0, help="Gaussian filter micrographs with this standard deviation (in pixels) before denoising (default: 0)")
    parser.add_argument("--inv-gaussian", type=float, default=0, help="Inverse Gaussian filter micrographs with this standard deviation (in pixels) before denoising (default: 0)")
    parser.add_argument("--deconvolve", action="store_true", help="apply optimal Gaussian deconvolution filter to each micrograph before denoising")
    parser.add_argument("--deconv-patch", type=int, default=1, help="apply spatial covariance correction to micrograph in this many patches (default: 1)")
    parser.add_argument("--pixel-cutoff", type=float, default=0, help="set pixels >= this number of standard deviations away from the mean to the mean. only used when set > 0 (default: 0)")
    parser.add_argument("--precision", choices=["f32", "bf16"], default="f32", help="inference precision: bf16 weights and activations with f32 statistics and output; f32 (TF32 off) keeps parity with the reference (default: f32)")
    parser.add_argument("-s", "--patch-size", type=int, default=1024, help="denoises micrographs in patches of this size. not used if < 1 (default: 1024)")
    parser.add_argument("-p", "--patch-padding", type=int, default=500, help="padding around each patch to remove edge artifacts (default: 500)")

    parser.add_argument("--method", choices=["noise2noise", "masked"], default="noise2noise", help="denoising training method (compatibility flag; noise2noise is used) (default: noise2noise)")
    parser.add_argument("--arch", choices=["unet", "unet-small", "unet2", "unet3", "fcnet", "fcnet2", "affine"], default="unet", help="denoising model architecture to train; the bundled weights are the starting point where the name has them (default: unet)")
    parser.add_argument("--optim", choices=["adam", "adagrad", "sgd"], default="adagrad", help="optimizer (default: adagrad)")
    parser.add_argument("--lr", default=0.001, type=float, help="learning rate for the optimizer (default: 0.001)")
    parser.add_argument("--criteria", default="L2", choices=["L0", "L1", "L2"], help="training criteria (default: L2)")
    parser.add_argument("-c", "--crop", type=int, default=800, help="training crop size (default: 800)")
    parser.add_argument("--batch-size", type=int, default=4, help="training batch size (default: 4)")
    parser.add_argument("--num-epochs", default=100, type=int, help="number of training epochs (default: 100)")
    parser.add_argument("--num-workers", default=16, type=int, help="number of threads for loading data during training (compatibility flag)")
    parser.add_argument("-j", "--num-threads", type=int, default=0, help="number of host threads (compatibility flag)")

    from topaz_tpu_torch.cli.fast import add_fast_flag

    add_fast_flag(parser)
    return parser


def main(args):
    from topaz_tpu_torch.cli.fast import apply_fast
    from topaz_tpu_torch.denoise import denoise_main

    apply_fast(args)  # --fast -> --precision bf16
    denoise_main(args)
