"""Trace containers over device-resident chain histories.

API-parity counterparts of the reference's pymc3-duck-typed trace machinery
(``/root/reference/pysgmcmc/diagnostics/sample_chains.py:14-384``):
``PYSGMCMCTrace`` (single chain: ``get_values``/``point``/slicing) and a
multi-chain container.  Two deliberate departures:

- Extraction is a single jitted ``lax.scan`` (``sample_chain``) or — for
  multiple chains — one ``vmap`` program over a sharded chain axis
  (:func:`pysgmcmc_tpu.parallel.chains.run_chains``), not one
  ``session.run`` per draw per chain in fresh graphs
  (reference ``sample_chains.py:369-382``).
- ``keep_every`` thinning actually happens inside the scan.  (The reference
  accepts ``keep_every`` but silently ignores it during extraction —
  ``sample_chains.py:98,166-169``.)

There is no pymc3 dependency; diagnostics consume the raw
``(n_chains, n_samples, ...)`` arrays directly
(:mod:`pysgmcmc_tpu.diagnostics.sampler_diagnostics`).

Examples
--------
>>> import numpy as np
>>> trace = PYSGMCMCTrace(0, {"x": np.arange(10.0)}, varnames=["x"])
>>> len(trace)
10
>>> trace.get_values("x", burn=2, thin=2)
array([2., 4., 6., 8.])
>>> trace.point(3)
{'x': array(3.)}
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np


def _default_varnames(leaves):
    if len(leaves) == 1:
        return ["x"]
    return ["x_{}".format(i) for i in range(len(leaves))]


class PYSGMCMCTrace:
    """A single sampled chain with named variables.

    Parameters
    ----------
    chain_id : hashable
        Identifier for this chain.
    samples : pytree
        Sampled positions with a leading sample axis on every leaf
        (as returned by ``sample_chain``).
    varnames : list of str, optional
        One name per pytree leaf.  Auto-enumerated when omitted, mirroring
        the reference's anonymous-variable naming
        (``sample_chains.py:82-95``).
    """

    def __init__(self, chain_id, samples, varnames=None):
        self.chain_id = chain_id
        leaves = jax.tree_util.tree_leaves(samples)
        if not leaves:
            raise ValueError("PYSGMCMCTrace: no samples provided")
        self._samples = samples
        self._leaves = leaves
        n_samples = {leaf.shape[0] for leaf in leaves}
        if len(n_samples) != 1:
            raise ValueError(
                "PYSGMCMCTrace: inconsistent sample counts across variables"
            )
        self.n_samples = n_samples.pop()

        if varnames is None:
            logging.warning(
                "PYSGMCMCTrace: no variable names given; enumerating "
                "variables as x, or x_0..x_%d", len(leaves) - 1
            )
            varnames = _default_varnames(leaves)
        if len(varnames) != len(leaves):
            raise ValueError(
                "PYSGMCMCTrace: got {} varnames for {} variables".format(
                    len(varnames), len(leaves)
                )
            )
        self.varnames = list(varnames)
        self._by_name = dict(zip(self.varnames, leaves))

    @classmethod
    def from_sampler(
        cls,
        chain_id,
        sampler,
        initial_position,
        n_samples,
        key,
        keep_every=1,
        batch_fn=None,
        varnames=None,
    ):
        """Draw ``n_samples`` (thinned by ``keep_every``) and wrap them.

        On-device analog of the reference's ``islice`` extraction
        (``sample_chains.py:97-181``) — one compiled scan.
        """
        from pysgmcmc_tpu.samplers.base import sample_chain

        if isinstance(key, int):
            key = jax.random.PRNGKey(key)
        key_init, key_run = jax.random.split(key)
        state = sampler.init(initial_position, key_init)
        _, positions, _ = sample_chain(
            sampler, state, key_run, n_samples,
            batch_fn=batch_fn, keep_every=keep_every,
        )
        return cls(chain_id, positions, varnames=varnames)

    def __len__(self):
        return self.n_samples

    def point(self, index):
        """Dict of variable values at ``index`` (cf. ``sample_chains.py:239-255``)."""
        return {
            name: np.asarray(leaf[index]) for name, leaf in self._by_name.items()
        }

    def __getitem__(self, index):
        if isinstance(index, slice):
            return self._slice(index)
        return self.point(index)

    def _slice(self, idx):
        sliced = jax.tree_util.tree_map(lambda leaf: leaf[idx], self._samples)
        return PYSGMCMCTrace(self.chain_id, sliced, varnames=self.varnames)

    def get_values(self, varname, burn=0, thin=1):
        """All recorded values of ``varname`` (cf. ``sample_chains.py:261-335``)."""
        if varname not in self._by_name:
            raise ValueError(
                "Queried `PYSGMCMCTrace` for values of variable '{}' but "
                "it only knows: {}".format(varname, self.varnames)
            )
        return np.asarray(self._by_name[varname][burn::thin])


class MultiTrace:
    """Container of per-chain :class:`PYSGMCMCTrace` objects.

    Replaces the reference's ``pymc3.backends.base.MultiTrace`` usage
    (``sample_chains.py:338-384``).
    """

    def __init__(self, traces):
        if not traces:
            raise ValueError("MultiTrace: need at least one trace")
        self.traces = list(traces)
        self.varnames = self.traces[0].varnames
        for trace in self.traces:
            if trace.varnames != self.varnames:
                raise ValueError("MultiTrace: traces disagree on varnames")

    @property
    def nchains(self):
        return len(self.traces)

    def __len__(self):
        return min(len(trace) for trace in self.traces)

    def get_values(self, varname, burn=0, thin=1, combine=True):
        values = [trace.get_values(varname, burn, thin) for trace in self.traces]
        if combine:
            return np.concatenate(values, axis=0)
        return values

    def chains_array(self, varname):
        """(n_chains, n_samples, ...) array for diagnostics."""
        return jnp.stack(
            [jnp.asarray(trace.get_values(varname)) for trace in self.traces]
        )


def pysgmcmc_multitrace(
    sampler,
    initial_position,
    key,
    n_chains=2,
    samples_per_chain=100,
    keep_every=10,
    batch_fn=None,
    jitter=0.0,
    varnames=None,
    mesh=None,
):
    """Build a :class:`MultiTrace` by running all chains in parallel.

    API-parity analog of the reference's ``pymc3_multitrace``
    (``sample_chains.py:338-384``), with the sequential fresh-graph loop
    replaced by one ``vmap`` (optionally mesh-sharded) program.
    """
    from pysgmcmc_tpu.parallel.chains import run_chains, stack_positions

    if isinstance(key, int):
        key = jax.random.PRNGKey(key)
    key_init, key_run = jax.random.split(key)
    positions = stack_positions(
        initial_position, n_chains, jitter=jitter, key=key_init
    )
    chains, _ = run_chains(
        sampler,
        positions,
        key_run,
        samples_per_chain,
        batch_fn=batch_fn,
        keep_every=keep_every,
        mesh=mesh,
    )
    # Trace containers are a host-side convenience view; gather the (possibly
    # mesh-sharded) histories to host once, then slice per chain.
    chains = jax.tree_util.tree_map(np.asarray, chains)
    traces = [
        PYSGMCMCTrace(
            chain_id,
            jax.tree_util.tree_map(lambda leaf: leaf[chain_id], chains),
            varnames=varnames,
        )
        for chain_id in range(n_chains)
    ]
    return MultiTrace(traces)
