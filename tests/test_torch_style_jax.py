"""The STROTSS style loss, value and canvas gradient, in the port against
the JAX package's ``StyleLoss`` at two scales.

A 66x70 canvas (scales 2 and 1) with the JAX package's draws fed, both
packages in float64: the value within 1e-4 relative, the canvas gradient
within 1e-3 relative (of its largest element); at an inactive iteration
exactly 0 with a zero gradient in both.  In float32 a ReLU input of the
random tower within rounding of its kink takes either side in the two
packages (one at 1.3e-6 parts the float32 gradients by 9e-4 of their
norm, the port's from float64's, while the JAX package's sits 7e-6 from
it): a tie, not a fault, so the gradient is held in float64.  The JAX loss
is jitted once, with the iteration as an argument (its compile, ~50 s on
the CPU, is most of this file's time); the port takes the active
iteration (its gate is tests/test_torch_style.py's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pixray_tpu.losses import style as JS
from pixray_tpu.models import vgg as JV
from pixray_tpu_torch.losses import style as PS
from pixray_tpu_torch.models.vgg import state_dict_from_flax_vgg16
from test_torch_style import _strotss_inputs, _style_args, jax_strotss_draws


def test_strotss_loss_gate_and_gradient_match_jax(tmp_path):
    """Both packages' ``StyleLoss.get_loss`` on either side of the gate,
    the style file resized by PIL in each."""
    params = JV.init_vgg16_params(jax.random.PRNGKey(16))
    hw = (66, 70)
    assert PS.strotss_scales(*hw) == [2, 1]
    out, _ = _strotss_inputs(hw, 3)
    args = _style_args(tmp_path)
    ref_loss = JS.StyleLoss(args)
    port_loss = PS.StyleLoss(args)
    port_loss.place("cpu", torch.float64, state_dict_from_flax_vgg16(params))
    port_loss.vgg.mean, port_loss.vgg.std = port_loss.vgg.mean.double(), port_loss.vgg.std.double()
    key = jax.random.PRNGKey(7)
    with jax.enable_x64(True):
        params64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a, np.float64)), params)
        # the JAX loss's own style tensor (PIL bicubic), widened to float64
        ref_loss.style_image = jnp.asarray(np.asarray(ref_loss._style_tensor(jnp.zeros((*hw, 3))), np.float64))
        draws = jax_strotss_draws(key, *hw)
        jfn = jax.jit(jax.value_and_grad(lambda o, it: ref_loss.get_loss(
            {}, o, args, globals={"cur_iteration": it}, key=key, params={"vgg": params64})))
        (jval, jg), (jval_off, jg_off) = (jfn(jnp.asarray(out[0], jnp.float64), jnp.int32(it)) for it in (4, 3))
    assert draws["0/uniforms"].dtype == torch.float64
    assert float(jval_off) == 0.0 and not np.asarray(jg_off).any()  # the JAX gate, off
    o = torch.tensor(out[0], dtype=torch.float64, requires_grad=True)
    val = port_loss.get_loss({}, o, args, globals={"cur_iteration": torch.tensor(4, dtype=torch.int32),
                                                   "draws": draws})
    (g,) = torch.autograd.grad(val, o)
    jg = np.asarray(jg)
    assert float(val.detach()) > 0
    np.testing.assert_allclose(float(val.detach()), float(jval), rtol=1e-4)
    np.testing.assert_allclose(g.numpy(), jg, rtol=1e-3, atol=1e-3 * np.abs(jg).max())
