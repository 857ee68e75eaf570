"""Closed-form celerite kernel and PSD evaluation.

JAX analog of the reference free functions ``get_kernel_value`` and
``get_psd_value`` (/root/reference/cpp/include/celerite/utils.h:106-163),
written as pure jnp expressions so they fuse under jit and broadcast over
arbitrary lag/frequency shapes.

The celerite kernel is

    k(tau) = sum_j a_r[j] exp(-c_r[j] |tau|)
           + sum_j exp(-c_c[j] |tau|) (a_c[j] cos(d_c[j] |tau|)
                                       + b_c[j] sin(d_c[j] |tau|))

and its power spectral density is

    S(omega) = sqrt(2/pi) * [
        sum_j a_r c_r / (c_r^2 + omega^2)
      + sum_j ((a_c c_c + b_c d_c)(c_c^2 + d_c^2)
               + (a_c c_c - b_c d_c) omega^2)
            / (omega^4 + 2 (c_c^2 - d_c^2) omega^2 + (c_c^2 + d_c^2)^2) ]
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["kernel_value", "psd_value"]


def kernel_value(a_real, c_real, a_comp, b_comp, c_comp, d_comp, tau):
    """Evaluate k(tau); broadcasts over the shape of ``tau``."""
    tau = jnp.abs(jnp.asarray(tau))
    t = tau[..., None]
    k_real = jnp.sum(a_real * jnp.exp(-c_real * t), axis=-1)
    k_comp = jnp.sum(
        jnp.exp(-c_comp * t)
        * (a_comp * jnp.cos(d_comp * t) + b_comp * jnp.sin(d_comp * t)),
        axis=-1,
    )
    return k_real + k_comp


def psd_value(a_real, c_real, a_comp, b_comp, c_comp, d_comp, omega):
    """Evaluate S(omega); broadcasts over the shape of ``omega``."""
    w2 = jnp.square(jnp.asarray(omega))[..., None]
    p_real = jnp.sum(a_real * c_real / (c_real**2 + w2), axis=-1)
    c2pd2 = c_comp**2 + d_comp**2
    num = (a_comp * c_comp + b_comp * d_comp) * c2pd2 + (
        a_comp * c_comp - b_comp * d_comp
    ) * w2
    den = w2 * w2 + 2.0 * (c_comp**2 - d_comp**2) * w2 + c2pd2 * c2pd2
    p_comp = jnp.sum(num / den, axis=-1)
    return jnp.sqrt(2.0 / jnp.pi) * (p_real + p_comp)
