"""Weight bridge: JAX parameter trees -> a reference-named torch state dict.

``p4fr_tpu.utils.convert_pth.export_state_dict`` (numpy-only at import)
inverts the JAX package's converter rules, so the result is exactly the
reference ``.pth`` layout that the port's modules use.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


def state_dict_from_jax(network: str, params, batch_stats: Optional[Dict] = None
                        ) -> Dict[str, torch.Tensor]:
    """Numpy (or array-like) ``params``/``batch_stats`` trees -> torch
    state dict. Raises if a JAX path has no rule."""
    from p4fr_tpu.utils.convert_pth import export_state_dict

    sd, unmatched = export_state_dict(network, params, batch_stats or {})
    if unmatched:
        raise ValueError(f"{len(unmatched)} JAX paths have no rule: {unmatched[:8]}")
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in sd.items()}
