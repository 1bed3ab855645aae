"""The policy's weights, made by the benchmark from the seed.

One ``torch.randn`` call on the run's device draws every parameter of an
``ActorCritic`` of obs width ``C`` and two hidden layers, in the order
``layout`` gives; each weight is scaled to the trainer's initial scale
(gain / sqrt(fan_in): sqrt(2) in the hidden layers, 0.01 on the policy
head, 1 on the value head), the biases to 0.01, and ``log_std`` is 0, the
trainer's initial value. Both the program (through
``load_state_dict``) and the reference read this same dict.
"""

import math

import torch


def layout(C, hidden):
    """(name, shape, scale) of every parameter, in draw order."""
    H1, H2 = (int(h) for h in hidden)
    g = math.sqrt(2.0)
    out = []
    for tower, head, gain in (("pi", "pi_out", 0.01), ("vf", "vf_out", 1.0)):
        a = 4 if tower == "pi" else 1
        for name, o, i, gn in ((f"{tower}.0", H1, C, g),
                               (f"{tower}.1", H2, H1, g),
                               (head, a, H2, gain)):
            out.append((f"{name}.weight", (o, i), gn / math.sqrt(i)))
            out.append((f"{name}.bias", (o,), 0.01))
    out.append(("log_std", (4,), 0.0))
    return out


def make_weights(C, hidden, seed, device):
    """The dict of parameter name -> float32 tensor on ``device``."""
    lay = layout(C, hidden)
    n = sum(math.prod(shape) for _, shape, _ in lay)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.randn(n, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, scale in lay:
        k = math.prod(shape)
        out[name] = (flat[off:off + k] * scale).reshape(shape)
        off += k
    return out
