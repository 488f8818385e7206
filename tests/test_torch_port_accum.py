"""Gradient accumulation and the K-FAC diagnostics against the JAX package.

* 2 ResNet-8 train steps (one block per stage; a refresh, a capture step) with gradient accumulation over 2 microbatches,
  K-FAC statistics from the last microbatch and from every one
  (``tests/test_torch_port_options.py::run_option_train_steps``: the
  loss, every tensor and the ``kfac_*`` diagnostics after every step, at
  its bounds);
* the diagnostics of ``KFAC(track_diagnostics=True)`` after a refresh, a
  stale-basis capture step and a plain step: ν, the damped eigenvalue
  range, norms, cosine and per-layer condition numbers at 1e-4 relative,
  the staleness count exactly.

A file of its own so that the test workers run it beside
``test_torch_port_options.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfac_pytorch_tpu import KFAC as JKFAC
from kfac_pytorch_tpu_torch import KFAC
from tests.test_torch_port_kfac import LAYERS, ConvDenseNet, _jparams, _problem
from tests.test_torch_port_options import _t, run_option_train_steps


@pytest.fixture(autouse=True)
def one_torch_thread():
    """PyTorch's CPU work on one thread: its OpenMP workers spin between ops
    and starve XLA (and the other test workers) of cores; these sizes are tiny."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("stats", ["last", "all"])
def test_accumulation_train_steps_match_jax(stats):
    run_option_train_steps(f"accum_{stats}")


def test_diagnostics_match_jax():
    lr, damping = 0.1, 0.003
    a_c, g_s, jgrads, tgrads = _problem(82)
    jk = JKFAC(lr=lr, damping=damping, layers=[v[0] for v in LAYERS.values()],
               track_diagnostics=True)
    tk = KFAC(lr=lr, damping=damping, layers=list(LAYERS), track_diagnostics=True, device="cpu")
    js, ts = jk.init(_jparams()), tk.init(ConvDenseNet())
    for upf, upe in [(True, True), (True, False), (False, False)]:
        _, js = jk.update(
            jgrads, js, a_contribs={LAYERS[n][0]: jnp.asarray(v) for n, v in a_c.items()},
            g_factor_stats={LAYERS[n][0]: jnp.asarray(v) for n, v in g_s.items()},
            lr=jnp.float32(lr), damping=jnp.float32(damping), update_factors=upf,
            update_eigen=upe,
        )
        _, ts = tk.update(
            tgrads, ts, a_contribs={n: _t(v) for n, v in a_c.items()},
            g_factor_stats={n: _t(v) for n, v in g_s.items()},
            lr=lr, damping=damping, update_factors=upf, update_eigen=upe,
        )
        jd, td = js["diagnostics"], ts["diagnostics"]
        assert int(td["eigen_stale_steps"]) == int(jd["eigen_stale_steps"])
        for k in ("nu", "min_damped_eig", "max_damped_eig", "grad_norm", "update_norm",
                  "update_grad_cos"):
            np.testing.assert_allclose(float(td[k]), float(jd[k]), rtol=1e-4, err_msg=k)
        for n, (jn, _, _) in LAYERS.items():
            for k in ("cond_A", "cond_G"):
                np.testing.assert_allclose(float(td["layer_cond"][n][k]),
                                           float(jd["layer_cond"][jn][k]), rtol=1e-4)
    assert float(td["min_damped_eig"]) >= damping * (1 - 1e-6)
