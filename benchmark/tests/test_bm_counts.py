"""Operation counts against hand-worked shapes."""

import pytest

from harness import spec
from reference import counts


def _layers(config):
    return spec.Cell(spec.load(), {"resnet8_u32-unet": "session.mixed"}[config]).config[
        "picker"]["layers"]


@pytest.mark.parametrize("config, per_pixel", [
    # conv7 1->32: 3,136; two 3x3 32->32 blocks: 4 x 18,432; 32->64 block
    # with its 1x1 projection: 18,432 + 36,864 + 4,096; 64->64 block:
    # 2 x 73,728; conv5 64->128: 409,600; the 1x1 head: 256
    ("resnet8_u32-unet", 656_704),
])
def test_bm_picker_flops(config, per_pixel):
    assert counts.picker_flops_per_pixel(_layers(config)) == per_pixel


def test_bm_unet_flops_by_hand():
    # one level, nf 2, base 3, top 1: enc1 2*9*2 = 36 at full size; enc2
    # 2*9*2*2 = 72 at 1/4; dec1 on 2nf+1 = 5 channels: 2*(5*64 + 64*32 + 32)
    assert counts.unet_flops_per_pixel(2, 3, 1, levels=1) == 36 + 72 / 4 + 2 * (5 * 64 + 2048 + 32)
    # the published unet: 305,074.5 an input pixel (76.4 ms at 4096^2 and 67 TFLOP/s)
    assert counts.unet_flops_per_pixel(48, 7, 3, 5) == pytest.approx(305_074.5)


def test_bm_em_counts():
    assert counts.em_evaluations(100, [0, 3, 10]) == 100 * (1 + 4 + 11)
    # 5 MUFU operations an evaluation over 132 SMs x 16 a clock at 1.98 GHz
    assert counts.em_bound_s(10**9) == pytest.approx(5e9 / (132 * 16 * 1.98e9))
