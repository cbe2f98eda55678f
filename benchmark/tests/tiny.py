"""A cell cut to a size the CPU runs in seconds, for the tests: the same
configuration and drivers, smaller micrographs and particles, short
windows."""

from harness import spec

SIZES = {
    "pipeline": [{"name": "falcon", "shape": [512, 512], "count": 3, "files": 2},
                 {"name": "k3", "shape": [512, 704], "count": 2, "files": 1}],
    "denoise": [{"name": "falcon", "shape": [256, 256], "count": 2, "files": 2}],
}


def tiny_cell(name: str) -> spec.Cell:
    cell = spec.Cell(spec.load(), name)
    t = cell.traffic
    t["micrograph"]["particle_radius_px"] = 12
    t["cameras"] = SIZES[t["driver"]]
    t["warm_passes"] = 1
    if t["driver"] == "pipeline":
        t["process"] = dict(t["process"], batch_size=2)
    return cell
