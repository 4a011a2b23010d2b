"""Weights and images drawn from the run's seed, on the device, in a few
large calls: one ``torch.Generator`` on the device, the weights first and
then the pool of image batches, so the same seed gives the same inputs."""
from __future__ import annotations

import torch

from bench.reference.plain import Entry

#: standard deviation of the biases (batch norm folded into them): not
#: zero, so that the bias path is compared
BIAS_STD = 0.1


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    return g


def make_params(table: list[Entry], g: torch.Generator,
                device: torch.device) -> dict:
    """He-scaled float32 weights in the served layouts and biases of
    ``BIAS_STD``, ``{layer: {"w", "b"}}``: views of two buffers."""
    shapes = [l.weight_shape() for l in table]
    sizes = [int(torch.Size(s).numel()) for s in shapes]
    scale = torch.repeat_interleave(
        torch.tensor([(2.0 / l.fan_in) ** 0.5 for l in table],
                     device=device),
        torch.tensor(sizes, device=device))
    w = torch.randn(sum(sizes), generator=g, device=device) * scale
    b = torch.randn(sum(l.c_out for l in table), generator=g,
                    device=device) * BIAS_STD
    params, ow, ob = {}, 0, 0
    for l, shape, n in zip(table, shapes, sizes):
        params[l.name] = {"w": w[ow:ow + n].view(shape),
                          "b": b[ob:ob + l.c_out]}
        ow += n
        ob += l.c_out
    return params


def make_pool(n: int, batch: int, image_px: int, channels: int,
              g: torch.Generator, device: torch.device) -> torch.Tensor:
    """``n`` distinct NHWC float32 batches of standard normal pixels."""
    return torch.randn((n, batch, image_px, image_px, channels),
                       generator=g, device=device)


def make_inputs(table: list[Entry], config: dict, traffic: dict, seed: int,
                device: torch.device) -> tuple[dict, torch.Tensor]:
    """The run's weights and its pool of image batches."""
    g = generator(seed, device)
    params = make_params(table, g, device)
    pool = make_pool(traffic["pool"], traffic["batch"], config["image_px"],
                     config["in_channels"], g, device)
    return params, pool
