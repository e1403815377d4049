"""Does a dense relaxed LP above 128 columns tell XLA's windowed sum
order from a plain in-order sum?

``relax.sum_order`` follows XLA:CPU's order of the pull's sum over the
flavor-resource columns up to ``relax.MAX_SUM_COLUMNS`` (128) and
refuses wider LPs, because no test LP there separates the windowed
order from a plain in-order one (ROADMAP Queue C item 8). This script
builds the dense LPs of tests/test_torch_relax.py
(``scenarios.dense_relax_lp`` of the 3-level, 3-resource, 6-ClusterQueue,
100-workload store) at F = 200 and 1,024 with the slack scaled down (every
column over capacity) and the values scaled up, and prints per case: in
how many rows the pull of iteration 0 differs between the two orders,
whether x differs, how many live x are interior, and (with ``--jax``)
whether the JAX program's x equals the windowed one, under
tests/conftest.py's XLA flags.

    JAX_PLATFORMS=cpu python tests/torch_relax_wide_probe.py [--jax]
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from torch_relax_pins import CONFTEST_XLA_FLAGS  # noqa: E402

if __name__ == "__main__":
    os.environ["XLA_FLAGS"] = CONFTEST_XLA_FLAGS
    os.environ["JAX_PLATFORMS"] = "cpu"

TIGHT = (1.0, 0.9, 0.7, 0.5, 0.3, 0.2, 0.05)
VALUE = (1.0, 4.0, 16.0, 64.0, 256.0)
WIDTHS = (200, 1024)


def main(with_jax: bool) -> None:
    import numpy as np
    import torch

    import test_torch_relax as TR
    from kueue_oss_tpu_torch import scenarios
    from kueue_oss_tpu_torch.solver import relax

    relax.MAX_SUM_COLUMNS = max(WIDTHS)  # probe above the refusal
    windowed = relax.sum_in_order

    def in_order(prod):
        out = torch.zeros(prod.shape[:-1], dtype=prod.dtype)
        for f in range(prod.shape[-1]):
            out = out + prod[..., f]
        return out

    pulls = []

    def spy(prod):
        pulls.append(prod.clone())
        return windowed(prod)

    def lp_of(lp, n_cols, tight, value):
        d = scenarios.dense_relax_lp(lp, n_cols, 3)
        return d._replace(slack=(d.slack * np.float32(tight)).astype(
            np.float32), s=(d.s * np.float32(value)).astype(np.float32))

    jp, pp = TR._problems(levels=3, n_res=3, n_cqs=6, n_wl=100, seed=3)
    if with_jax:
        from kueue_oss_tpu.solver import relax as jax_relax
    for n_cols in WIDTHS:
        for tight in TIGHT:
            for value in VALUE:
                lp = lp_of(relax.build_lp(pp), n_cols, tight, value)
                pulls.clear()
                relax.sum_in_order = spy
                x = TR._lp_x(lp, 32)
                relax.sum_in_order = in_order
                y = TR._lp_x(lp, 32)
                relax.sum_in_order = windowed
                first = pulls[0]
                rows = int((windowed(first).numpy().view(np.int32)
                            != in_order(first).numpy().view(np.int32))
                           .sum())
                live = lp.live
                interior = float(((x[live] > 0) & (x[live] < 1)).mean())
                line = (f"F={n_cols} slack x{tight} s x{value}: pull rows "
                        f"differing at iteration 0 {rows}, x differs "
                        f"{not TR._same_bits(x, y)}, interior "
                        f"{interior:.3f}")
                if with_jax:
                    want = np.asarray(jax_relax._single_lp(32)(lp_of(
                        jax_relax.build_lp(jp), n_cols, tight, value)))
                    line += f", JAX x == windowed {TR._same_bits(x, want)}"
                print(line, flush=True)


if __name__ == "__main__":
    main("--jax" in sys.argv[1:])
