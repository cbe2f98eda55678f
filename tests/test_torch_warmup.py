"""The port's ``warmup`` on the CPU: ``parse_shapes`` equal to the JAX
package's on the same inputs (errors included), the command's flags, a
warmup that runs every shape x batch size and the denoiser once and says
what carries over (the CUDA kernels' build on the card; never a compile
cache), and its refusals without a GPU or with ``-d -2``."""

import numpy as np
import pytest
import torch

from topaz_tpu.warmup import parse_shapes as jax_parse_shapes
from topaz_tpu_torch.cli.main import build_parser, main
from topaz_tpu_torch.warmup import parse_shapes, warmup
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("text", ["4096x4096", "128x96, 64x64", "4096x4096,5760x4092,",
                                  " 10X20 ", "4096", "", "axb", "1x2x3"])
def test_parse_shapes_equal_to_jax(text):
    try:
        want = jax_parse_shapes(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_shapes(text)
        assert str(got.value) == str(e)
        return
    assert parse_shapes(text) == want


def test_warmup_cli_registration():
    args = build_parser().parse_args(
        ["warmup", "-m", "resnet8_u32", "--shapes", "4096x4096,5760x4092",
         "--batch-sizes", "1,8", "--denoise-model", "unet", "--fast"])
    assert args.shapes == "4096x4096,5760x4092" and args.fast and args.device == 0
    assert callable(args.func)


def test_warmup_runs_every_program_once_on_the_cpu(capsys):
    n = warmup(model="resnet8_u32", denoise_model="affine", scale=4, radius=4,
               shapes=((64, 64), (48, 80)), batch_sizes=(1, 2), device="cpu")
    assert n == 2 * 2 + 2
    err = capsys.readouterr().err
    assert err.count("warmup: extract") == 4 and err.count("warmup: denoise") == 2
    assert "6 programs run once" in err and "on cpu" in err
    assert "compiled" not in err and "cache" not in err
    assert "CUDA kernels" not in err  # nothing to build for the CPU


def test_warmup_cli_on_the_cpu(capsys):
    main(["warmup", "-m", "resnet8_u32", "--shapes", "64x64", "--batch-sizes", "2,1,2",
          "-s", "4", "-r", "4", "-d", "cpu"])
    err = capsys.readouterr().err
    assert "extract 64x64 batch 1" in err and "extract 64x64 batch 2" in err
    assert "2 programs run once" in err


@pytest.mark.parametrize("argv,message", [
    (["warmup", "--shapes", "64x64"], "no CUDA device"),
    (["warmup", "--shapes", "64x64", "-d", "-1"], "no CUDA device"),
    (["warmup", "--shapes", "64x64", "-d", "-2"], "no CUDA device"),
])
def test_warmup_cli_refuses_without_cuda_or_with_every_device(monkeypatch, argv, message):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        main(argv)
    assert message in str(e.value.code)


def test_warmup_builds_the_kernels_first_on_a_cuda_device(monkeypatch, capsys):
    """On a CUDA device the kernels are built before any program runs; the
    device itself is faked here and the programs run on the CPU."""
    import topaz_tpu_torch._build as build
    import topaz_tpu_torch.device as device_mod

    order = []
    monkeypatch.setattr(build, "build_libraries",
                        lambda names: order.append(("build", tuple(names)))
                        or {n: f"/x/_build/lib{n}.so" for n in names})
    real = device_mod.resolve_device

    class FakeCuda:
        type = "cuda"

        def __str__(self):
            return "cuda:0"

    def resolve(device="cuda"):
        if device == "cuda":
            order.append(("resolve", "cuda"))
            return FakeCuda()
        return real("cpu")

    monkeypatch.setattr(device_mod, "resolve_device", resolve)
    import topaz_tpu_torch.pipeline as pipeline_mod
    monkeypatch.setattr(pipeline_mod, "resolve_device", lambda device: real("cpu"))
    n = warmup(model="resnet8_u32", scale=4, radius=4, shapes=((64, 64),), batch_sizes=(1,))
    assert n == 1
    assert order == [("resolve", "cuda"), ("build", ("disk_max",))]
    err = capsys.readouterr().err
    assert err.index("CUDA kernels disk_max built") < err.index("warmup: extract")
    assert "carries over to later processes" in err
