"""topaz convert (topaz/commands/convert.py): the JAX CLI's flags and
defaults (topaz_tpu/cli/commands/convert.py), on the port's pandas-free
tables."""
import argparse
import glob
import os
import sys

import numpy as np

name = "convert"
help = ("convert particle coordinate files between various formats "
        "automatically. also allows filtering particles by score threshold "
        "and UP- and DOWN-scaling coordinates.")


def add_arguments(parser=None):
    if parser is None:
        parser = argparse.ArgumentParser(help)
    parser.add_argument("files", nargs="+", help="path to input particle file(s); multiple inputs are concatenated")
    parser.add_argument("-o", "--output", help="path to output particle file (default: stdout)")
    parser.add_argument("--from", dest="_from", choices=["auto", "coord", "csv", "star", "box"], default="auto", help="file format of the INPUT file (default: auto)")
    parser.add_argument("--to", choices=["auto", "coord", "csv", "star", "json", "box"], default="auto", help="file format of the OUTPUT file; JSON/BOX need a destination directory (default: auto)")
    parser.add_argument("--suffix", default="", help="suffix to append to file names when writing to directory (default: none)")
    parser.add_argument("-t", "--threshold", type=float, default=-np.inf, help="threshold the particles by score (optional)")
    parser.add_argument("-s", "--down-scale", type=float, default=1, help="DOWN-scale coordinates by this factor (default: 1)")
    parser.add_argument("-x", "--up-scale", type=float, default=1, help="UP-scale coordinates by this factor (default: 1)")
    parser.add_argument("--voltage", type=float, default=-1, help="voltage metadata (optional)")
    parser.add_argument("--detector-pixel-size", type=float, default=-1, help="detector pixel size metadata (optional)")
    parser.add_argument("--magnification", type=float, default=-1, help="magnification metadata (optional)")
    parser.add_argument("--amplitude-contrast", type=float, default=-1, help="amplitude contrast metadata (optional)")
    parser.add_argument("--invert-y", action="store_true", help="invert (mirror) the y-axis particle coordinates. requires --imagedir.")
    parser.add_argument("--imagedir", help="directory of images, required to invert the y-axis")
    parser.add_argument("--image-ext", default=".mrc", help="image file extension (default=.mrc)")
    parser.add_argument("--boxsize", default=0, type=int, help="size of particle boxes, required for BOX format")
    parser.add_argument("-v", "--verbose", type=int, default=0, help="verbosity of information printed (default: 0)")
    return parser


def _metadata_flags(args, names):
    return zip((args.voltage, args.detector_pixel_size, args.magnification,
                args.amplitude_contrast), names)


def main(args):
    from topaz_tpu_torch.io import coordinates as file_utils
    from topaz_tpu_torch.io import star
    from topaz_tpu_torch.io.coordinates import UnknownFormatError, mirror_y_axis
    from topaz_tpu_torch.io.image import load_image
    from topaz_tpu_torch.io.table import Table, concat

    verbose = args.verbose
    from_forms = [args._from] * len(args.files)
    if args._from == "auto":
        try:
            from_forms = [file_utils.detect_format(p) for p in args.files]
        except UnknownFormatError as e:
            print(f"Error: unrecognized input coordinates file extension ({e.ext})", file=sys.stderr)
            sys.exit(1)
    formats_detected = list(set(from_forms))
    if verbose > 0:
        print("# INPUT formats detected: " + str(formats_detected), file=sys.stderr)

    output_path = args.output
    output = None
    to_form = args.to
    if output_path is None:
        output = sys.stdout
        if to_form == "auto":
            if len(formats_detected) == 1:
                to_form = from_forms[0]
            else:
                print("Error: writing to stdout with multiple input formats and no --to format set!", file=sys.stderr)
                sys.exit(1)
        if to_form in ("box", "json"):
            print("Error: writing BOX or JSON output files requires a destination directory (--output)!", file=sys.stderr)
            sys.exit(1)

    image_ext = args.image_ext
    boxsize = args.boxsize
    if to_form == "auto":
        if output_path.endswith("/"):
            to_form = "box" if boxsize > 0 else "json"
            if verbose > 0:
                print(f"# Detected output format is {to_form.upper()} (OUTPUT is a directory).", file=sys.stderr)
        else:
            try:
                to_form = file_utils.detect_format(output_path)
            except UnknownFormatError as e:
                print(f"Error: unrecognized output coordinates file extension ({e.ext})", file=sys.stderr)
                sys.exit(1)
    if verbose > 0:
        print("# OUTPUT format: " + to_form, file=sys.stderr)

    t = args.threshold
    scale = args.up_scale / args.down_scale

    # STAR to STAR keeps every STAR column
    if formats_detected == ["star"] and to_form == "star":
        tables = []
        for path in args.files:
            with open(path) as f:
                tables.append(Table(star.parse(f)))
        table = concat(tables)
        if star.SCORE_COLUMN_NAME in table:
            table = table.take(table[star.SCORE_COLUMN_NAME] >= t)
        if scale != 1:
            for col in (star.X_COLUMN_NAME, star.Y_COLUMN_NAME):
                table[col] = np.round(scale * table[col]).astype(int)
        for flag, col in _metadata_flags(args, (star.VOLTAGE, star.DETECTOR_PIXEL_SIZE,
                                                star.MAGNIFICATION, star.AMPLITUDE_CONTRAST)):
            if flag > 0:
                table[col] = flag
        if output is None:
            with open(output_path, "w") as f:
                star.write(table, f)
        else:
            star.write(table, output)
        return

    coords = concat([file_utils.read_coordinates_table(p, format=fm)
                     for p, fm in zip(args.files, from_forms)])
    if "score" in coords:
        coords = coords.take(coords["score"] >= t)
    if scale != 1:
        coords["x_coord"] = np.round(scale * coords["x_coord"]).astype(int)
        coords["y_coord"] = np.round(scale * coords["y_coord"]).astype(int)
    for flag, col in _metadata_flags(args, ("voltage", "detector_pixel_size", "magnification",
                                            "amplitude_contrast")):
        if flag > 0:
            coords[col] = flag

    if args.invert_y:
        if args.imagedir is None:
            print("Error: --imagedir must specify the directory of images in order to mirror the y-axis coordinates", file=sys.stderr)
            sys.exit(1)
        # '.mrc', 'mrc' and '*' all work for --image-ext
        ext = image_ext.lstrip(".") or "*"
        mirrored = []
        for image_name, group in coords.groupby("image_name"):
            pattern = os.path.join(args.imagedir, image_name) + "." + ext
            matches = glob.glob(pattern)
            if not matches:
                print(f"Error: no image matches {pattern} (needed to mirror "
                      f"the y-axis)", file=sys.stderr)
                sys.exit(1)
            mirrored.append(mirror_y_axis(group, load_image(matches[0]).shape[0]))
        coords = concat(mirrored)

    if to_form in ("box", "json"):
        file_utils.write_coordinates(output_path, coords, format=to_form, boxsize=boxsize,
                                     image_ext=image_ext, suffix=args.suffix)
    elif output is None:
        with open(output_path, "w") as f:
            file_utils.write_table(f, coords, format=to_form, boxsize=boxsize,
                                   image_ext=image_ext)
    else:
        file_utils.write_table(output, coords, format=to_form, boxsize=boxsize,
                               image_ext=image_ext)
