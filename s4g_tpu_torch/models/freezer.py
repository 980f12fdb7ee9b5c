"""Parameter freezing by regex patterns (port of s4g_tpu/models/freezer.py,
and of the reference's Freezer, which flipped `requires_grad`).

Patterns are regexes searched in the port's parameter names (the reference
torch names, `sa_modules.0.mlp.1.bn.weight`, ...).  A frozen parameter
gets `requires_grad=False`, so it takes no gradient, and
`train.optim.build_optimizer` leaves it out of every group: no update and
no weight decay, as the JAX package's `optax.set_to_zero` branch.
BatchNorm running statistics are buffers, not parameters: they still move
in training mode, as JAX's `batch_stats` do.

Example patterns:
    ['^(sa|fp)_modules']          - the backbone (SA and FP modules)
    ['^((?!seg).)*$']             - everything except the score head
    ['bn']                        - every BatchNorm scale and bias
"""

from __future__ import annotations

import re
from typing import Sequence

from torch import nn


def param_path_matches(path: str, patterns: Sequence[str]) -> bool:
    return any(re.search(p, path) for p in patterns)


def frozen_param_names(net: nn.Module, patterns: Sequence[str]) -> list:
    """Names of the parameters that `patterns` freeze."""
    return [name for name, _ in net.named_parameters()
            if param_path_matches(name, patterns)]


def freeze_by_patterns(net: nn.Module, patterns: Sequence[str]) -> list:
    """Set `requires_grad=False` on every parameter whose name matches a
    pattern; returns their names."""
    names = frozen_param_names(net, patterns)
    params = dict(net.named_parameters())
    for name in names:
        params[name].requires_grad_(False)
    return names
