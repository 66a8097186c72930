"""Packed multi-chain state for the sampling and burn-in hot loops.

A stacked parameter pytree with leaves like ``(chains, 50, 50)`` or
``(chains, 50, 2)`` can also be held as one dense matrix, so the sampler's
elementwise update runs over a single array instead of one small array per
leaf.  Two layouts are provided:

- *slots* (:func:`make_pack_spec`): ``(n_chains, width)``, each leaf in a
  128-aligned column slot;
- *lanes* (:func:`make_lanes_spec`): ``(rows, n_chains)``, chains on the
  minor axis and each leaf on an 8-aligned run of rows.

The gradient still wants pytree leaves, so each step unpacks ``theta``
into compute-dtype leaves for the vmapped gradient and packs the gradients
back.

The update rules themselves are the plain ``jnp`` functions
:func:`sghmc_update`, :func:`sgld_update`, :func:`psgld_update`,
:func:`rsghmc_update`, :func:`sgnht_update` and
:func:`adaptive_burnin_update`.  They take the standard-normal draw as an
argument, so tests compare them with the pytree samplers' ``step`` given
identical noise.  The pytree path
(:func:`pysgmcmc_tpu.samplers.base.sample_chain`) remains the reference
implementation.

Examples
--------
>>> import jax, jax.numpy as jnp
>>> template = {"w": jnp.zeros((2, 3)), "b": jnp.zeros(2)}
>>> spec = make_pack_spec(template)
>>> spec.width  # two leaves -> two 128-lane slots
256
>>> stacked = jax.tree_util.tree_map(
...     lambda l: jnp.broadcast_to(l, (4,) + l.shape), template)
>>> flat = pack_tree(spec, stacked)
>>> flat.shape
(4, 256)
>>> out = unpack_tree(spec, flat)
>>> out["w"].shape
(4, 2, 3)
"""

from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pysgmcmc_tpu.samplers.psgld import PSGLDSampler, PSGLDState
from pysgmcmc_tpu.samplers.relativistic_sghmc import (
    RelativisticSGHMCSampler,
    RelativisticSGHMCState,
)
from pysgmcmc_tpu.samplers.sghmc import SGHMCSampler, SGHMCState
from pysgmcmc_tpu.samplers.sgld import SGLDSampler, SGLDState
from pysgmcmc_tpu.samplers.sgnht import SGNHTSampler, SGNHTState

LANES = 128


def pad_dim(dim):
    """Round ``dim`` up to a multiple of the 128-column slot width."""
    return ((dim + LANES - 1) // LANES) * LANES


#  Update rules -----------------------------------------------------------
#
# Each mirrors the matching pytree sampler's ``step`` term by term (same
# operation order, so equal inputs give equal outputs).  ``grad`` is the
# cost gradient without the folded Gaussian prior; ``eta`` is the
# standard-normal draw.  Arithmetic runs in float32; state arrays may be
# stored narrower and are cast on the way in.


def sghmc_update(theta, v, grad, minv, eps, eta, mdecay, scale_grad,
                 prior_scale=0.0):
    """SGHMC step (``samplers/sghmc.py``) -> ``(theta, v)`` in float32."""
    eps_scaled = eps / jnp.sqrt(jnp.asarray(scale_grad, jnp.float32))
    g = grad.astype(jnp.float32) + prior_scale * theta
    minv = minv.astype(jnp.float32)
    v = v.astype(jnp.float32)
    sigma = jnp.sqrt(jnp.maximum(
        2.0 * eps_scaled**2 * mdecay * minv - eps_scaled**4, 1e-16))
    v = v - eps**2 * minv * g - mdecay * v + sigma * eta
    return theta + v, v


def sgld_update(theta, grad, minv, eps, eta, a_coef, scale_grad,
                prior_scale=0.0):
    """SGLD step (``samplers/sgld.py``) -> ``theta``."""
    g = grad.astype(jnp.float32) + prior_scale * theta
    minv = minv.astype(jnp.float32)
    sg = jnp.asarray(scale_grad, jnp.float32)
    c = jnp.asarray(1e-16, jnp.float32)
    sigma = jnp.sqrt(jnp.maximum(
        2.0 * eps * ((minv * a_coef) / (sg + 2.0 * jnp.sign(sg) * c + c)),
        0.0))
    return theta - eps * minv * a_coef * g + sigma * eta


def psgld_update(theta, v, grad, eps, eta, alpha, lambda_reg, scale_grad,
                 prior_scale=0.0):
    """pSGLD step (``samplers/psgld.py``) -> ``(theta, v)``."""
    g = grad.astype(jnp.float32) + prior_scale * theta
    v = alpha * v.astype(jnp.float32) + (1.0 - alpha) * g * g
    precond = 1.0 / (lambda_reg + jnp.sqrt(jnp.maximum(v, 0.0)))
    sigma = jnp.sqrt(jnp.maximum(eps * precond / scale_grad, 0.0))
    return theta - 0.5 * eps * precond * g + sigma * eta, v


def rsghmc_update(theta, p, grad, eps, eta, d_coef, bhat, mass,
                  speed_of_light, prior_scale=0.0):
    """Relativistic SGHMC step (``samplers/relativistic_sghmc.py``)
    -> ``(theta, p)``."""
    g = -(grad.astype(jnp.float32) + prior_scale * theta)
    m, c = mass, speed_of_light

    def velocity(pp):
        return eps * pp / (m * jnp.sqrt(pp * pp / (m**2 * c**2) + 1.0))

    p = p.astype(jnp.float32)
    noise_scale = jnp.sqrt(eps * (2.0 * d_coef - eps * bhat))
    p = p + eps * g + noise_scale * eta - d_coef * velocity(p)
    return theta + velocity(p), p


def sgnht_update(theta, p, grad, xi, eps, eta, a_diff, scale_grad,
                 prior_scale=0.0):
    """SGNHT momentum and position step (``samplers/sgnht.py``)
    -> ``(theta, p)``.  The thermostat update needs the kinetic energy
    summed over each chain's real parameters, which depends on the
    layout, so the caller does it."""
    g = grad.astype(jnp.float32) + prior_scale * theta
    sigma = jnp.sqrt(2.0 * a_diff * eps / jnp.asarray(scale_grad, jnp.float32))
    p = p.astype(jnp.float32)
    p = p - xi * eps * p - eps * g + sigma * eta
    return theta + eps * p, p


def adaptive_burnin_update(theta, v, tau, g, v_hat, grad, eps, eta,
                           scale_grad, prior_scale=0.0, mdecay=None,
                           a_coef=None):
    """One self-tuning burn-in step (``samplers/_adaptive.py``) of SGHMC
    (``mdecay`` given) or SGLD (``a_coef`` given).

    Returns ``(theta, v, tau, g, v_hat, minv)``; ``v`` is ``None`` for
    SGLD and ``minv`` is the mass-matrix inverse this step used.
    """
    small = 1e-16
    gg = grad.astype(jnp.float32) + prior_scale * theta
    sqrt_vhat = jnp.sqrt(jnp.maximum(v_hat, 0.0))
    minv = 1.0 / (sqrt_vhat + 2.0 * jnp.sign(sqrt_vhat) * small + small)
    denom = v_hat + 2.0 * jnp.sign(v_hat) * small + small
    tau_new = tau + (-g * g * tau) / denom + 1.0
    r = 1.0 / (tau + 1.0)
    g = g - r * g + r * gg
    v_hat = v_hat - r * v_hat + r * gg * gg
    if mdecay is not None:
        theta, v = sghmc_update(theta, v, gg, minv, eps, eta, mdecay,
                                scale_grad)
    else:
        theta = sgld_update(theta, gg, minv, eps, eta, a_coef, scale_grad)
    return theta, v, tau_new, g, v_hat, minv


_KINDS = {
    "sghmc": SGHMCSampler, "sgld": SGLDSampler, "psgld": PSGLDSampler,
    "rsghmc": RelativisticSGHMCSampler, "sgnht": SGNHTSampler,
}


def _sampler_kind(sampler, driver, kinds):
    for kind in kinds:
        if isinstance(sampler, _KINDS[kind]):
            return kind
    raise NotImplementedError(
        "{} supports {}; got {!r}".format(
            driver, ", ".join(_KINDS[k].__name__ for k in kinds),
            type(sampler).__name__)
    )


#  Layouts -----------------------------------------------------------------


class PackSpec(NamedTuple):
    """Layout of a pytree packed into 128-aligned column slots."""

    treedef: Any
    shapes: Any      # tuple of per-leaf shapes (without the chain axis)
    sizes: Any       # tuple of per-leaf element counts
    offsets: Any     # tuple of slot start columns
    width: int       # total packed width (multiple of 128)


def make_pack_spec(template):
    """Build the slot layout from a single-chain parameter pytree."""
    leaves, treedef = jax.tree_util.tree_flatten(template)
    shapes = tuple(tuple(leaf.shape) for leaf in leaves)
    sizes = tuple(int(np.prod(s)) if s else 1 for s in shapes)
    offsets, off = [], 0
    for size in sizes:
        offsets.append(off)
        off += pad_dim(size)
    return PackSpec(treedef, shapes, sizes, tuple(offsets), off)


def pack_mask(spec, dtype=jnp.float32):
    """(1, width) mask: 1 on real columns, 0 on slot padding."""
    mask = np.zeros((1, spec.width), np.float32)
    for off, size in zip(spec.offsets, spec.sizes):
        mask[0, off:off + size] = 1.0
    return jnp.asarray(mask, dtype)


def pack_tree(spec, stacked, dtype=jnp.float32):
    """Stacked pytree (leaves ``(n, *shape)``) -> dense ``(n, width)``."""
    leaves = jax.tree_util.tree_flatten(stacked)[0]
    n = leaves[0].shape[0]
    parts = []
    for leaf, size in zip(leaves, spec.sizes):
        flat = leaf.reshape(n, size).astype(dtype)
        slot = pad_dim(size)
        if slot != size:
            flat = jnp.pad(flat, ((0, 0), (0, slot - size)))
        parts.append(flat)
    return jnp.concatenate(parts, axis=1)


def unpack_tree(spec, flat, dtype=None):
    """Dense ``(n, width)`` -> stacked pytree, optionally cast to ``dtype``."""
    n = flat.shape[0]
    leaves = []
    for off, size, shape in zip(spec.offsets, spec.sizes, spec.shapes):
        leaf = flat[:, off:off + size].reshape((n,) + shape)
        if dtype is not None:
            leaf = leaf.astype(dtype)
        leaves.append(leaf)
    return jax.tree_util.tree_unflatten(spec.treedef, leaves)


def _schedule_eps(sampler, schedule_state, step):
    eps = sampler.stepsize_schedule.value(schedule_state, step)
    return jnp.asarray(eps, jnp.float32)


def _shared_schedule_state(states, driver="this driver"):
    """Collapse a stacked per-chain schedule state to the shared one.

    The packed/stacked drivers advance all chains at ONE stepsize, so a
    stacked schedule state is only admissible when every chain carries the
    same values.  Heterogeneous concrete states (e.g. a per-chain
    :class:`~pysgmcmc_tpu.stepsize_schedules.TracedStepsizeSchedule`
    sweep) raise instead of silently running every chain at chain 0's
    stepsize; under tracing the values cannot be inspected — use
    :func:`sample_chain_lanes` (native per-chain eps) or the pytree path
    for stepsize sweeps.
    """
    schedule_state = states.schedule_state
    leaves = jax.tree_util.tree_leaves(schedule_state)
    if leaves:
        for leaf in leaves:
            if isinstance(leaf, jax.core.Tracer) or jnp.ndim(leaf) < 1:
                continue
            arr = np.asarray(leaf)
            if not (arr == arr[:1]).all():
                raise ValueError(
                    "{}: chains carry heterogeneous per-chain schedule "
                    "state, but this driver advances all chains at one "
                    "shared stepsize.  Use sample_chain_lanes (which "
                    "supports per-chain stepsizes) or the pytree path "
                    "for stepsize sweeps.".format(driver)
                )
        # stacked homogeneous schedule state: lockstep chains share it
        schedule_state = jax.tree_util.tree_map(
            lambda l: l[0] if jnp.ndim(l) >= 1 else l, schedule_state
        )
    return schedule_state


def _lanes_eps_fn(sampler, states, n_chains):
    """Per-step stepsize closure for the chains-on-lanes drivers.

    With a stacked per-chain schedule state (every leaf carrying a
    leading ``n_chains`` axis — the
    :class:`~pysgmcmc_tpu.stepsize_schedules.TracedStepsizeSchedule`
    sweep pattern) this returns a ``(1, n_chains)`` per-chain stepsize
    row each step, which broadcasts across each chain's parameter rows, so
    one compiled program advances every chain at its own stepsize.
    Otherwise a scalar.
    """
    ss = states.schedule_state
    leaves = jax.tree_util.tree_leaves(ss)
    per_chain = bool(leaves) and all(
        jnp.ndim(leaf) >= 1 and leaf.shape[0] == n_chains
        for leaf in leaves
    )
    if per_chain:
        def eps_of(step):
            vec = jax.vmap(
                lambda s: sampler.stepsize_schedule.value(s, step)
            )(ss)
            return jnp.asarray(vec, jnp.float32).reshape(1, n_chains)
        return eps_of

    shared = jax.tree_util.tree_map(
        lambda l: l[0] if jnp.ndim(l) >= 1 else l, ss
    ) if leaves else ss

    def eps_of(step):
        return _schedule_eps(sampler, shared, step)
    return eps_of


def _run_sharded(body, states, key, mesh, axis_name):
    """shard_map ``body(states, key) -> chain-leading outputs`` over a mesh.

    Chains are pure SPMD (zero collectives in the hot loop), so the whole
    driver body — packing, per-step gradient, update — runs on every
    device over its local slice of chains.

    Every leaf of ``states`` is normalized to carry a leading chain axis
    (scalars broadcast), so ONE PartitionSpec prefix shards the entire
    state/outputs pytree.  The PRNG key is replicated in and folded with
    the device's mesh coordinates inside the body, so shards draw
    decorrelated streams.  Outputs are therefore deterministic in
    (inputs, mesh) but not bitwise-equal to the unsharded run.  (The
    pytree path via :func:`pysgmcmc_tpu.parallel.chains.run_chains` does
    give bitwise sharded == unsharded; statistical parity of this path is
    pinned in ``tests/parallel/test_sharded_kernels.py``.)
    """
    from jax.sharding import PartitionSpec

    from pysgmcmc_tpu.parallel.mesh import mesh_chain_axes

    axes = mesh_chain_axes(mesh, axis_name)
    n_chains = jax.tree_util.tree_leaves(states.position)[0].shape[0]
    n_dev = mesh.devices.size
    if n_chains % n_dev:
        raise ValueError(
            "sharded driver: n_chains ({}) must be divisible by "
            "the mesh size ({})".format(n_chains, n_dev)
        )

    def bcast(leaf):
        if jnp.ndim(leaf) == 0 or jnp.shape(leaf)[0] != n_chains:
            return jnp.broadcast_to(
                jnp.asarray(leaf)[None], (n_chains,) + jnp.shape(leaf)
            )
        return leaf

    states = jax.tree_util.tree_map(bcast, states)
    spec = PartitionSpec(axes)
    axis_list = axes if isinstance(axes, tuple) else (axes,)

    def shard_body(states, key):
        for ax in axis_list:
            key = jax.random.fold_in(key, jax.lax.axis_index(ax))
        return body(states, key)

    return jax.shard_map(
        shard_body, mesh=mesh,
        in_specs=(spec, PartitionSpec()),
        out_specs=spec,
    )(states, key)


class LanesSpec(NamedTuple):
    """Row-slot layout of a pytree packed chains-on-lanes."""

    treedef: Any
    shapes: Any      # per-leaf shapes (without the chain axis)
    sizes: Any       # per-leaf element counts
    offsets: Any     # slot start rows (8-aligned)
    rows: int        # total packed rows


def _align(x, m):
    return ((x + m - 1) // m) * m


def make_lanes_spec(template, row_align=8, total_align=None):
    """Slot layout for :func:`pack_lanes` from a single-chain pytree.

    Each leaf occupies a run of rows aligned to ``row_align`` (8); the
    total is aligned up to ``total_align``.  ``total_align=None`` picks 256
    for network-sized states but only ``row_align`` for tiny ones (e.g.
    the 1-2 dim objective targets of the ESS sweeps, where a 256-row floor
    would be 100x padding).
    """
    leaves, treedef = jax.tree_util.tree_flatten(template)
    shapes = tuple(tuple(leaf.shape) for leaf in leaves)
    sizes = tuple(int(np.prod(s)) if s else 1 for s in shapes)
    offsets, off = [], 0
    for size in sizes:
        offsets.append(off)
        off += _align(size, row_align)
    if total_align is None:
        total_align = 256 if off > 128 else row_align
    return LanesSpec(
        treedef, shapes, sizes, tuple(offsets), _align(off, total_align)
    )


def pack_lanes(spec, stacked, dtype=jnp.float32):
    """Stacked pytree (leaves ``(n, *shape)``) -> dense ``(rows, n)``.

    The chain axis lands on the minor dimension, so the elementwise update
    streams one dense matrix with no per-leaf padding beyond the 8-row
    slots.
    """
    leaves = jax.tree_util.tree_flatten(stacked)[0]
    n = leaves[0].shape[0]
    parts = []
    for leaf, size in zip(leaves, spec.sizes):
        block = leaf.reshape(n, size).T.astype(dtype)
        pad = _align(size, 8) - size
        if pad:
            block = jnp.pad(block, ((0, pad), (0, 0)))
        parts.append(block)
    total_pad = spec.rows - sum(_align(s, 8) for s in spec.sizes)
    if total_pad:
        parts.append(jnp.zeros((total_pad, n), dtype))
    return jnp.concatenate(parts, axis=0)


def unpack_lanes(spec, flat, dtype=None):
    """Dense ``(rows, n)`` -> stacked pytree ``(n, *shape)`` (cast opt.)."""
    n = flat.shape[1]
    leaves = []
    for off, size, shape in zip(spec.offsets, spec.sizes, spec.shapes):
        leaf = flat[off:off + size]           # (size, n), row slice
        leaf = leaf.reshape(shape + (n,))     # free: row-major compatible
        perm = (len(shape),) + tuple(range(len(shape)))
        leaf = jnp.transpose(leaf, perm)      # chains back to the front
        if dtype is not None:
            leaf = leaf.astype(dtype)
        leaves.append(leaf)
    return jax.tree_util.tree_unflatten(spec.treedef, leaves)


def _vmapped_grad(sampler, batch_fn):
    return jax.vmap(
        lambda pos, batch: jax.value_and_grad(sampler.cost_fn)(pos, batch)
        if batch is not None
        else jax.value_and_grad(sampler.cost_fn)(pos),
        in_axes=(0, 0 if batch_fn is not None else None),
    )


def _swap_chain_axis(positions, costs):
    """(n_samples, n_chains, ...) scan outputs -> chain-leading."""
    if positions is not None:
        positions = jax.tree_util.tree_map(
            lambda l: jnp.swapaxes(l, 0, 1), positions
        )
    return positions, jnp.swapaxes(costs, 0, 1)


#  Drivers -------------------------------------------------------------------


def sample_chain_lanes(
    sampler,
    states,
    key,
    n_samples,
    batch_fn=None,
    keep_every=1,
    compute_dtype=jnp.bfloat16,
    state_dtype=jnp.float32,
    collect_positions=True,
    mesh=None,
    axis_name=None,
):
    """Sampling-phase driver with chains-on-lanes packed state.

    The state is packed as a dense ``(rows, n_chains)`` matrix — chains on
    the minor axis, leaves on 8-aligned row slots:

    - ``theta``/``v``/``minv`` live packed across the whole scan (packed
      once, outside).
    - Each step unpacks ``theta`` to ``compute_dtype`` row-major leaves for
      the vmapped gradient and packs the gradients back.
    - The update is one elementwise pass over the packed matrices with
      threefry noise.

    Row-slot padding needs no mask: padding rows are never unpacked, and
    their drift under the (minv=0) noise floor is a bounded ~1e-8 random
    walk.

    ``mesh`` shards the chain axis over a device mesh via
    :func:`_run_sharded` — the whole driver runs SPMD per device with zero
    hot-loop collectives.  Returns ``(states, positions, costs)`` shaped
    like :func:`pysgmcmc_tpu.samplers.base.sample_chain`.
    """
    if mesh is not None:
        from pysgmcmc_tpu.parallel.mesh import CHAIN_AXIS

        def body(local_states, local_key):
            return sample_chain_lanes(
                sampler, local_states, local_key, n_samples,
                batch_fn=batch_fn, keep_every=keep_every,
                compute_dtype=compute_dtype, state_dtype=state_dtype,
                collect_positions=collect_positions,
            )

        return _run_sharded(
            body, states, key, mesh, axis_name or CHAIN_AXIS)

    kind = _sampler_kind(
        sampler, "sample_chain_lanes",
        ("sghmc", "sgld", "psgld", "rsghmc", "sgnht"))

    n_chains = jax.tree_util.tree_leaves(states.position)[0].shape[0]
    template = jax.tree_util.tree_map(lambda l: l[0], states.position)
    spec = make_lanes_spec(template)

    theta = pack_lanes(spec, states.position)
    # state_dtype=bfloat16 keeps the momentum/accumulator and the frozen
    # mass-matrix inverse in bf16 (update arithmetic stays f32): halves
    # their traffic for an O(2^-8) relative rounding — far below the
    # injected sampling noise (moments pinned in tests).
    if kind in ("sghmc", "rsghmc", "sgnht"):
        v = pack_lanes(spec, states.momentum, dtype=state_dtype)
    elif kind == "psgld":
        v = pack_lanes(spec, states.v, dtype=state_dtype)
    else:
        v = None
    minv = (
        pack_lanes(spec, states.stats.minv, dtype=state_dtype)
        if kind in ("sghmc", "sgld") else None
    )
    if kind == "sgnht":
        # per-chain thermostat scalar on the lanes, plus the row mask /
        # real-dim count its cross-row kinetic-energy reduction needs
        # (padding rows random-walk under the injected noise and must not
        # count toward p^T p)
        xi = jnp.asarray(states.xi, jnp.float32).reshape(1, n_chains)
        rowmask = np.zeros((spec.rows, 1), np.float32)
        for off, size in zip(spec.offsets, spec.sizes):
            rowmask[off:off + size] = 1.0
        rowmask = jnp.asarray(rowmask)
        n_dim = float(sum(spec.sizes))
    else:
        xi = None

    grad_fn = _vmapped_grad(sampler, batch_fn)
    scale_grad = getattr(sampler, "scale_grad", 1.0)
    prior_scale = getattr(sampler, "gaussian_prior_scale", 0.0)
    eps_of = _lanes_eps_fn(sampler, states, n_chains)
    step0 = jnp.max(states.step) if jnp.ndim(states.step) else states.step

    def one_step(carry, _):
        theta, v, xi, key, step = carry
        key, key_step = jax.random.split(key)
        theta_tree = unpack_lanes(spec, theta, compute_dtype)
        if batch_fn is not None:
            batches = jax.vmap(batch_fn)(
                jax.random.split(key_step, n_chains)
            )
            cost, grads = grad_fn(theta_tree, batches)
        else:
            cost, grads = grad_fn(theta_tree, None)
        grad_flat = pack_lanes(
            spec, grads, dtype=jax.tree_util.tree_leaves(grads)[0].dtype
        )
        eps = eps_of(step)
        key, key_noise = jax.random.split(key)
        eta = jax.random.normal(key_noise, theta.shape, jnp.float32)
        if kind == "sghmc":
            theta, v = sghmc_update(
                theta, v, grad_flat, minv, eps, eta, sampler.mdecay,
                scale_grad, prior_scale)
        elif kind == "sgld":
            theta = sgld_update(
                theta, grad_flat, minv, eps, eta, sampler.A, scale_grad,
                prior_scale)
        elif kind == "psgld":
            theta, v = psgld_update(
                theta, v, grad_flat, eps, eta, sampler.alpha,
                sampler.lambda_reg, scale_grad, prior_scale)
        elif kind == "rsghmc":
            theta, v = rsghmc_update(
                theta, v, grad_flat, eps, eta, sampler.D, sampler.Bhat,
                sampler.mass, sampler.speed_of_light, prior_scale)
        else:
            theta, v = sgnht_update(
                theta, v, grad_flat, xi, eps, eta, sampler.a_diff,
                scale_grad, prior_scale)
            sumsq = jnp.sum(jnp.square(v * rowmask), axis=0)
            xi = xi + eps * (sumsq.reshape(1, n_chains) / n_dim - 1.0)
        if v is not None:
            v = v.astype(state_dtype)
        return (theta, v, xi, key, step + 1), cost

    def thinned(carry, _):
        carry, costs = jax.lax.scan(one_step, carry, None, length=keep_every)
        out = unpack_lanes(spec, carry[0]) if collect_positions else None
        return carry, (out, costs[-1])

    (theta, v, xi, _, _), (positions, costs) = jax.lax.scan(
        thinned, (theta, v, xi, key, step0), None, length=n_samples
    )

    common = dict(
        position=unpack_lanes(spec, theta),
        step=states.step + n_samples * keep_every,
        schedule_state=states.schedule_state,
    )
    if kind == "sghmc":
        new_states = SGHMCState(
            momentum=unpack_lanes(spec, v, jnp.float32),
            stats=states.stats, **common)
    elif kind == "psgld":
        new_states = PSGLDState(v=unpack_lanes(spec, v, jnp.float32), **common)
    elif kind == "rsghmc":
        new_states = RelativisticSGHMCState(
            momentum=unpack_lanes(spec, v, jnp.float32), **common)
    elif kind == "sgnht":
        new_states = SGNHTState(
            momentum=unpack_lanes(spec, v, jnp.float32),
            xi=xi.reshape(n_chains), **common)
    else:
        new_states = SGLDState(stats=states.stats, **common)
    return (new_states,) + _swap_chain_axis(positions, costs)


def sample_chain_stacked(
    sampler,
    states,
    key,
    n_samples,
    batch_fn=None,
    keep_every=1,
    bf16_params=False,
    collect_positions=True,
):
    """Sampling-phase SGHMC driver over stacked (native-layout) state.

    The scan runs *outside* a per-step ``vmap`` (scan-of-vmap instead of
    vmap-of-scan), so the update operates on whole stacked leaves with one
    threefry draw per leaf.

    With ``bf16_params=True`` the cost function is evaluated on a bfloat16
    copy of the position, so the gradient stays bfloat16 end to end.  The
    cost function must accept bfloat16 leaves (the mixed-precision cost
    functions here do: they cast inputs to their compute dtype, a no-op
    for an already-bf16 tree).

    Returns ``(states, positions, costs)`` like
    :func:`pysgmcmc_tpu.samplers.base.sample_chain`, with stacked leading
    ``(n_chains, n_samples, ...)`` axes.
    """
    _sampler_kind(sampler, "sample_chain_stacked", ("sghmc",))
    from pysgmcmc_tpu.utils.pytree import normal_like_tree

    n_chains = jax.tree_util.tree_leaves(states.position)[0].shape[0]
    minv = states.stats.minv
    schedule_state0 = _shared_schedule_state(states, "sample_chain_stacked")
    step0 = jnp.max(states.step) if jnp.ndim(states.step) else states.step
    grad_fn = _vmapped_grad(sampler, batch_fn)

    def one_step(carry, _):
        theta, v, key, step = carry
        key, key_step = jax.random.split(key)
        pos_in = theta
        if bf16_params:
            pos_in = jax.tree_util.tree_map(
                lambda l: l.astype(jnp.bfloat16), theta)
        if batch_fn is not None:
            batches = jax.vmap(batch_fn)(
                jax.random.split(key_step, n_chains)
            )
            cost, grads = grad_fn(pos_in, batches)
        else:
            cost, grads = grad_fn(pos_in, None)
        eps = _schedule_eps(sampler, schedule_state0, step)
        key, key_noise = jax.random.split(key)
        eta = normal_like_tree(key_noise, theta)
        new = jax.tree_util.tree_map(
            lambda t, vv, g, mi, e: sghmc_update(
                t, vv, g, mi, eps, e, sampler.mdecay, sampler.scale_grad,
                sampler.gaussian_prior_scale),
            theta, v, grads, minv, eta,
        )
        theta = jax.tree_util.tree_map(
            lambda _, pair: pair[0], theta, new)
        v = jax.tree_util.tree_map(lambda _, pair: pair[1], v, new)
        return (theta, v, key, step + 1), cost

    def thinned(carry, _):
        carry, costs = jax.lax.scan(one_step, carry, None, length=keep_every)
        out = carry[0] if collect_positions else None
        return carry, (out, costs[-1])

    (theta, v, _, _), (positions, costs) = jax.lax.scan(
        thinned, (states.position, states.momentum, key, step0), None,
        length=n_samples,
    )

    new_states = SGHMCState(
        position=theta,
        momentum=v,
        stats=states.stats,
        step=states.step + n_samples * keep_every,
        schedule_state=states.schedule_state,
    )
    return (new_states,) + _swap_chain_axis(positions, costs)


def sample_chain_packed(
    sampler,
    states,
    key,
    n_samples,
    batch_fn=None,
    keep_every=1,
    compute_dtype=jnp.bfloat16,
    collect_positions=True,
):
    """Sampling-phase SGHMC driver over slot-packed flat state.

    The packed analog of
    :func:`pysgmcmc_tpu.samplers.base.sample_chain(..., phase="sampling")`
    for stacked multi-chain SGHMC states (every leaf carries a leading
    chain axis; ``states.step >= burn_in_steps`` for all chains — run the
    burn-in with the pytree path first).

    Per step: unpack ``theta`` into ``compute_dtype`` leaves, evaluate the
    vmapped minibatch gradient, and advance ``(theta, v)`` with one
    elementwise pass over the ``(n_chains, width)`` matrices.

    Returns ``(states, positions, costs)`` where ``positions`` is the
    unpacked stacked pytree with a ``(n_chains, n_samples, ...)`` leading
    layout and ``costs`` is ``(n_chains, n_samples)``.

    The PRNG stream differs from (but is as valid as) the pytree path's:
    noise comes from one flat threefry draw, and minibatch keys derive
    from one split per step rather than per chain.
    """
    _sampler_kind(sampler, "sample_chain_packed", ("sghmc",))

    n_chains = jax.tree_util.tree_leaves(states.position)[0].shape[0]
    template = jax.tree_util.tree_map(lambda l: l[0], states.position)
    spec = make_pack_spec(template)
    mask = pack_mask(spec)

    theta = pack_tree(spec, states.position)
    v = pack_tree(spec, states.momentum)
    minv = pack_tree(spec, states.stats.minv)
    grad_fn = _vmapped_grad(sampler, batch_fn)
    schedule_state0 = _shared_schedule_state(states, "sample_chain_packed")
    step0 = jnp.max(states.step) if jnp.ndim(states.step) else states.step

    def one_step(carry, _):
        theta, v, key, step = carry
        key, key_step = jax.random.split(key)
        theta_tree = unpack_tree(spec, theta, compute_dtype)
        if batch_fn is not None:
            batches = jax.vmap(batch_fn)(
                jax.random.split(key_step, n_chains)
            )
            cost, grads = grad_fn(theta_tree, batches)
        else:
            cost, grads = grad_fn(theta_tree, None)
        grad_flat = pack_tree(
            spec, grads, dtype=jax.tree_util.tree_leaves(grads)[0].dtype
        )
        eps = _schedule_eps(sampler, schedule_state0, step)
        key, key_noise = jax.random.split(key)
        eta = jax.random.normal(key_noise, theta.shape, jnp.float32)
        # masked noise keeps the slot padding (theta = v = minv = 0) at
        # exactly zero
        theta, v = sghmc_update(
            theta, v, grad_flat, minv, eps, eta * mask, sampler.mdecay,
            sampler.scale_grad, sampler.gaussian_prior_scale)
        return (theta, v, key, step + 1), cost

    def thinned(carry, _):
        carry, costs = jax.lax.scan(one_step, carry, None, length=keep_every)
        out = unpack_tree(spec, carry[0]) if collect_positions else None
        return carry, (out, costs[-1])

    (theta, v, _, _), (positions, costs) = jax.lax.scan(
        thinned, (theta, v, key, step0), None, length=n_samples
    )

    new_states = SGHMCState(
        position=unpack_tree(spec, theta),
        momentum=unpack_tree(spec, v),
        stats=states.stats,
        step=states.step + n_samples * keep_every,
        schedule_state=states.schedule_state,
    )
    return (new_states,) + _swap_chain_axis(positions, costs)


def burnin_chain_lanes(
    sampler,
    states,
    key,
    n_steps,
    batch_fn=None,
    compute_dtype=jnp.bfloat16,
    state_dtype=jnp.float32,
    mesh=None,
    axis_name=None,
):
    """Burn-in driver with chains-on-lanes packed state.

    The burn-in analog of :func:`sample_chain_lanes` for the adaptive
    samplers (SGHMC, SGLD): each step runs the whole Springenberg et al.
    self-tuning update — tau/g/v_hat EMAs, mass-matrix inverse, noise and
    parameter update (:func:`adaptive_burnin_update`; semantics of
    :func:`pysgmcmc_tpu.samplers._adaptive.update_stats` with
    ``phase="burn_in"``, reference
    ``/root/reference/pysgmcmc/samplers/sghmc.py:126-196``) — over the
    packed ``(rows, n_chains)`` state.

    Per-chain stepsizes (stacked
    :class:`~pysgmcmc_tpu.stepsize_schedules.TracedStepsizeSchedule`
    state) are supported exactly as in :func:`sample_chain_lanes`.

    Returns the advanced states (with ``stats.minv`` holding the
    mass-matrix inverse the final step used — the value the sampling phase
    freezes).
    """
    if mesh is not None:
        from pysgmcmc_tpu.parallel.mesh import CHAIN_AXIS

        def body(local_states, local_key):
            return burnin_chain_lanes(
                sampler, local_states, local_key, n_steps,
                batch_fn=batch_fn, compute_dtype=compute_dtype,
                state_dtype=state_dtype,
            )

        return _run_sharded(
            body, states, key, mesh, axis_name or CHAIN_AXIS)

    from pysgmcmc_tpu.samplers._adaptive import AdaptiveStats

    kind = _sampler_kind(
        sampler, "burnin_chain_lanes (adaptive samplers)", ("sghmc", "sgld"))
    is_sghmc = kind == "sghmc"

    n_chains = jax.tree_util.tree_leaves(states.position)[0].shape[0]
    template = jax.tree_util.tree_map(lambda l: l[0], states.position)
    spec = make_lanes_spec(template)

    theta = pack_lanes(spec, states.position)
    v = (
        pack_lanes(spec, states.momentum, dtype=state_dtype)
        if is_sghmc else None
    )
    tau = pack_lanes(spec, states.stats.tau)
    g = pack_lanes(spec, states.stats.g)
    v_hat = pack_lanes(spec, states.stats.v_hat)
    minv = pack_lanes(spec, states.stats.minv)

    grad_fn = _vmapped_grad(sampler, batch_fn)
    scale_grad = getattr(sampler, "scale_grad", 1.0)
    prior_scale = getattr(sampler, "gaussian_prior_scale", 0.0)
    eps_of = _lanes_eps_fn(sampler, states, n_chains)
    step0 = jnp.max(states.step) if jnp.ndim(states.step) else states.step

    def one_step(carry, _):
        theta, v, tau, g, v_hat, minv, key, step = carry
        key, key_step = jax.random.split(key)
        theta_tree = unpack_lanes(spec, theta, compute_dtype)
        if batch_fn is not None:
            batches = jax.vmap(batch_fn)(
                jax.random.split(key_step, n_chains)
            )
            _, grads = grad_fn(theta_tree, batches)
        else:
            _, grads = grad_fn(theta_tree, None)
        grad_flat = pack_lanes(
            spec, grads, dtype=jax.tree_util.tree_leaves(grads)[0].dtype
        )
        key, key_noise = jax.random.split(key)
        eta = jax.random.normal(key_noise, theta.shape, jnp.float32)
        theta, v, tau, g, v_hat, minv = adaptive_burnin_update(
            theta, v, tau, g, v_hat, grad_flat, eps_of(step), eta,
            scale_grad, prior_scale,
            mdecay=sampler.mdecay if is_sghmc else None,
            a_coef=None if is_sghmc else sampler.A,
        )
        if v is not None:
            v = v.astype(state_dtype)
        return (theta, v, tau, g, v_hat, minv, key, step + 1), ()

    (theta, v, tau, g, v_hat, minv, _, _), _ = jax.lax.scan(
        one_step, (theta, v, tau, g, v_hat, minv, key, step0), None,
        length=n_steps,
    )

    common = dict(
        position=unpack_lanes(spec, theta),
        stats=AdaptiveStats(
            tau=unpack_lanes(spec, tau),
            g=unpack_lanes(spec, g),
            v_hat=unpack_lanes(spec, v_hat),
            minv=unpack_lanes(spec, minv),
        ),
        step=states.step + n_steps,
        schedule_state=states.schedule_state,
    )
    if is_sghmc:
        return SGHMCState(momentum=unpack_lanes(spec, v, jnp.float32), **common)
    return SGLDState(**common)
