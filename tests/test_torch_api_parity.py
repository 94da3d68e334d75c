"""The public API of climt_tpu_torch against the JAX package's.

An ``ast`` walk of both packages finds every public module-level name,
class and method of ``climt_tpu/`` in the port, with a signature that a
call written for JAX fits: JAX's parameters in JAX's order, the port's
extra ones optional (``device`` anywhere).  The exceptions are the
ROADMAP's do-not-port list (code no runtime path of the JAX package
reaches, or which kernel B replaces) and two departures pinned below.

The calls that once differed are held against JAX at float64 on the
CPU: the RRTMG band constants; ``dtype=`` of the cloud and aerosol
optics; ``held_suarez_forcing`` in degrees of latitude; ``bucket_step``
with JAX's flags; ``DistributedSHT.grid_sharding``/``spec_sharding``.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import DTensor

import climt_tpu
import climt_tpu_torch
from climt_tpu.components import bucket_hydrology as JB
from climt_tpu.components import held_suarez as JH
from climt_tpu.components.rrtmg import lw_spectral as JL
from climt_tpu.components.rrtmg import sw_spectral as JS
from climt_tpu_torch.components import bucket_hydrology as TB
from climt_tpu_torch.components import held_suarez as TH
from climt_tpu_torch.components.rrtmg import lw_spectral as TL
from climt_tpu_torch.components.rrtmg import mcica as TM
from climt_tpu_torch.components.rrtmg import rtrn_kernel
from climt_tpu_torch.components.rrtmg import sw_spectral as TS
from climt_tpu_torch.ops.sht import SphericalHarmonicTransform
from climt_tpu_torch.parallel import DistributedSHT, grid_sharding, make_mesh

from torch_helpers import rel_err, world_of_one

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ROADMAP.md queue 1, "Do not port": modules and names
DO_NOT_PORT_MODULES = {'components/rrtmg/interp.py',
                       'components/rrtmg/pallas_rtrn.py'}
DO_NOT_PORT_NAMES = {('components/rrtmg/fused_mix.py', 'BandAccum'),
                     ('components/rrtmg/fused_mix.py', 'fused_mix_rows')}
# the two departures that stay, each pinned by a test of this file
RENAMED = {('core/util.py', 'jax_version_of'),
           ('__init__.py', 'jax_version_of')}
FIRST_ARGUMENT = {('components/rrtmg/mcica.py', 'mcica_subcolumns'):
                  ('key', 'generator')}


def _port_path(rel):
    if rel == 'data/__init__.py':       # the data package is data.py
        return 'data.py'
    return rel


def _public_names(tree, with_imports):
    """{name: node} of a module's public top-level defs, classes and
    assignments (and, for a package's __init__, its imported names)."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    out[t.id] = node
        elif with_imports and isinstance(node, ast.ImportFrom):
            for alias in node.names:
                out[alias.asname or alias.name] = node
    return {k: v for k, v in out.items() if not k.startswith('_')}


def _fits(jax_fn, port_fn, first=None):
    """'' if a call written for ``jax_fn`` fits ``port_fn``, else why."""
    def params(fn):
        a = fn.args
        names = [x.arg for x in a.posonlyargs + a.args]
        defaults = set(names[len(names) - len(a.defaults):])
        kw = {x.arg: d is not None for x, d in zip(a.kwonlyargs,
                                                   a.kw_defaults)}
        return names, defaults, kw, a.vararg, a.kwarg

    jn, _, jkw, jva, jvk = params(jax_fn)
    pn, pdef, pkw, pva, pvk = params(port_fn)
    if first is not None:
        assert jn[0] == first[0] and pn[0] == first[1], (jn, pn)
        jn, pn = jn[1:], pn[1:]
    extra = [n for n in pn if n == 'device']
    pn = [n for n in pn if n != 'device']
    if pn[:len(jn)] != jn:
        return 'positional %s, JAX %s' % (pn, jn)
    missing = [n for n in pn[len(jn):] + extra if n not in pdef]
    if missing:
        return 'extra parameters without a default: %s' % missing
    if set(jkw) - set(pkw) or any(not d for n, d in pkw.items()
                                  if n not in jkw and n != 'device'):
        return 'keyword-only %s, JAX %s' % (sorted(pkw), sorted(jkw))
    if (jva and not pva) or (jvk and not pvk):
        return '*args/**kwargs'
    return ''


def _api_differences():
    found = []
    jax_root = os.path.join(ROOT, 'climt_tpu')
    for dirpath, _, files in os.walk(jax_root):
        for name in sorted(files):
            if not name.endswith('.py'):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), jax_root)
            rel = rel.replace(os.sep, '/')
            if rel in DO_NOT_PORT_MODULES:
                continue
            port_file = os.path.join(ROOT, 'climt_tpu_torch', _port_path(rel))
            if not os.path.exists(port_file):
                found.append('module %s' % rel)
                continue
            init = name == '__init__.py'
            with open(os.path.join(dirpath, name)) as f:
                jax_names = _public_names(ast.parse(f.read()), init)
            with open(port_file) as f:     # a name imported is there too
                port_names = _public_names(ast.parse(f.read()), True)
            for key, node in jax_names.items():
                if (rel, key) in DO_NOT_PORT_NAMES | RENAMED:
                    continue
                if key not in port_names:
                    found.append('%s: %s' % (rel, key))
                    continue
                other = port_names[key]
                if isinstance(node, ast.FunctionDef) and isinstance(
                        other, ast.FunctionDef):
                    why = _fits(node, other, FIRST_ARGUMENT.get((rel, key)))
                    if why:
                        found.append('%s: %s(): %s' % (rel, key, why))
                if not (isinstance(node, ast.ClassDef)
                        and isinstance(other, ast.ClassDef)):
                    continue
                methods = {m.name: m for m in other.body
                           if isinstance(m, ast.FunctionDef)}
                attrs = _public_names(other, False)
                for m in node.body:
                    if not isinstance(m, ast.FunctionDef) or (
                            m.name.startswith('_') and m.name != '__init__'):
                        continue
                    if m.name not in methods and m.name not in attrs:
                        found.append('%s: %s.%s' % (rel, key, m.name))
                    elif m.name in methods and not m.decorator_list:
                        why = _fits(m, methods[m.name])
                        if why:
                            found.append('%s: %s.%s(): %s' % (
                                rel, key, m.name, why))
    return found


def test_every_public_name_of_the_jax_package_has_a_counterpart():
    """JAX's cached_property transforms (DistributedSHT.analyze, ...)
    are checked for presence only: their calls take the arguments of the
    shard_map'd body."""
    assert _api_differences() == []


@pytest.mark.parametrize('port,fits', [
    ('def f(a, b, device="cuda", c=1): pass', True),
    ('def f(a, c): pass', False),
    ('def f(a, b, c): pass', False),
    ('def f(a, *, b=1): pass', False)])
def test_the_signature_rule(port, fits):
    """A call f(a, b) written for JAX's ``def f(a, b)``: the port may
    add optional parameters and ``device``, nothing else."""
    jax_fn, = ast.parse('def f(a, b): pass').body
    port_fn, = ast.parse(port).body
    assert (_fits(jax_fn, port_fn) == '') == fits


# -- the two departures that stay ---------------------------------------------

def test_mcica_subcolumns_refuses_a_prng_key():
    """JAX draws from a PRNG key; the port from a torch.Generator
    (ROADMAP queue 3, "McICA draws cannot be matched bit for bit")."""
    cld = torch.full((3, 2), 0.5, dtype=torch.float64)
    tau = torch.ones((3, 2, 16), dtype=torch.float64)
    with pytest.raises(TypeError, match='torch.Generator'):
        TM.mcica_subcolumns(jax.random.PRNGKey(0), 1, cld, cld, cld, tau,
                            TL.NGB)
    gen = torch.Generator().manual_seed(0)
    out = TM.mcica_subcolumns(gen, 1, cld, cld, cld, tau, TL.NGB)
    assert out[0].shape == (3, 2, 140)


def test_version_helper_is_named_for_torch():
    assert callable(climt_tpu.jax_version_of)
    assert callable(climt_tpu_torch.torch_version_of)
    assert not hasattr(climt_tpu_torch, 'jax_version_of')
    from climt_tpu_torch.core import util
    assert not hasattr(util, 'jax_version_of')


# -- the RRTMG band constants -------------------------------------------------

@pytest.mark.parametrize('module,name', [
    ('lw', n) for n in ('NBANDS', 'NGPT', 'NG', 'NGS', 'NGB')] + [
    ('sw', n) for n in ('NBANDS', 'NGPT', 'NG', 'NGS', 'NGB')])
def test_band_constants_equal_jax(module, name):
    port, ref = {'lw': (TL, JL), 'sw': (TS, JS)}[module]
    a, b = getattr(port, name), getattr(ref, name)
    assert type(a) is type(b)
    if isinstance(b, np.ndarray):
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


def test_lw_constants_have_one_definition():
    for name in ('NBANDS', 'NGPT', 'NG', 'NGS', 'NGB'):
        assert getattr(TL, name) is getattr(rtrn_kernel, name)


# -- dtype= of the cloud and aerosol optics ---------------------------------

NZ, NCOL = 6, 5


def _cloud_inputs(seed=2):
    rng = np.random.RandomState(seed)

    def sparse(scale, *shape):
        shape = shape or (NZ, NCOL)
        return np.where(rng.rand(*shape) > 0.4, scale * rng.rand(*shape),
                        0.0)

    return dict(
        cld=sparse(1.0), ciwp=sparse(30.0), clwp=sparse(80.0),
        rei=5.0 + 125.0 * rng.rand(NZ, NCOL),
        rel=2.5 + 55.0 * rng.rand(NZ, NCOL),
        tau_lw=2.0 * rng.rand(NZ, NCOL, 16),
        cldmc=(rng.rand(NZ, NCOL, 140) > 0.5).astype(float),
        ciwpmc=sparse(30.0, NZ, NCOL, 140),
        clwpmc=sparse(80.0, NZ, NCOL, 140),
        taumc=2.0 * rng.rand(NZ, NCOL, 140),
        tauc=2.0 * rng.rand(NZ, NCOL, 14), ssac=rng.rand(NZ, NCOL, 14),
        asmc=0.9 * rng.rand(NZ, NCOL, 14),
        fsfc=0.5 * rng.rand(NZ, NCOL, 14),
        ecaer=0.05 * rng.rand(6, NZ, NCOL))


CLOUDS = _cloud_inputs()
OPTICS = {
    'cldprop_lw': [(1, 0, 0), (2, 0, 0), (2, 2, 1), (2, 3, 1)],
    'cldprmc_lw': [(1, 0, 1), (2, 1, 1), (2, 3, 0)],
    'cldprop_sw': [(0, 1, 1), (2, 1, 1), (2, 2, 1), (2, 3, 0)],
    'ecmwf_aerosol_optics': [()],
}
ARGS = {'cldprop_lw': ('cld', 'tau_lw', 'ciwp', 'clwp', 'rei', 'rel'),
        'cldprmc_lw': ('cldmc', 'ciwpmc', 'clwpmc', 'taumc', 'rei', 'rel'),
        'cldprop_sw': ('cld', 'tauc', 'ssac', 'asmc', 'fsfc', 'ciwp', 'clwp',
                       'rei', 'rel'),
        'ecmwf_aerosol_optics': ('ecaer',)}
# (inputs, dtype): None is the call without dtype, held against JAX's call
# with the inputs' dtype
DTYPES = [('float64', 'float64'), ('float64', 'float32'),
          ('float32', 'float32'), ('float64', None)]
# by the tables' dtype: float64 tables agree to the last bits; with
# float32 tables JAX reads a few coefficients from its float64 numpy
# tables (absice0, the Ebert-Curry ice terms) that the port reads at
# float32, and casts a float64 product to float32 at the end
TOL = {'float64': 1e-13, 'float32': 1e-6}


@pytest.mark.parametrize('inputs,dtype', DTYPES)
@pytest.mark.parametrize('fn,flags', [(fn, f) for fn, fl in OPTICS.items()
                                      for f in fl])
def test_optics_dtype_matches_jax(fn, flags, inputs, dtype):
    port = getattr(TL if fn.endswith('_lw') else TS, fn)
    ref = getattr(JL if fn.endswith('_lw') else JS, fn)
    args = [CLOUDS[n] for n in ARGS[fn]]
    outs_j = ref(*flags, *(jnp.asarray(a, inputs) for a in args),
                 jnp.dtype(dtype or inputs))
    t_args = [torch.as_tensor(a, dtype=getattr(torch, inputs)) for a in args]
    kw = {} if dtype is None else dict(dtype=getattr(torch, dtype))
    outs_t = port(*flags, *t_args, **kw)
    if not isinstance(outs_j, tuple):
        outs_j, outs_t = (outs_j,), (outs_t,)
    assert len(outs_t) == len(outs_j)
    for a, b in zip(outs_t, outs_j):
        if (fn, flags[:2], inputs) == ('cldprop_lw', (2, 0), 'float32'):
            # JAX's iceflag-0 coefficients are float64 numpy scalars
            # whatever dtype says (lw_spectral.py:623), which promote
            # float32 inputs to float64 under x64; the port stays float32
            assert (str(a.dtype), str(b.dtype)) == ('torch.float32',
                                                    'float64')
        else:
            assert str(a.dtype) == 'torch.' + str(b.dtype)
        assert rel_err(a, b) <= TOL[dtype or inputs]
    if dtype is None:
        # the call without dtype is the call with the inputs' dtype
        same = port(*flags, *t_args, dtype=getattr(torch, inputs))
        same = same if isinstance(same, tuple) else (same,)
        for a, b in zip(outs_t, same):
            assert torch.equal(a, b)


# -- held_suarez_forcing in JAX's form ----------------------------------------

def _hs_inputs(ncol=24, nz=10, seed=4):
    """(ncol, nz) winds, temperature and pressure, (ncol,) surface
    pressure and latitudes in degrees, as HeldSuarez.array_call gives
    them (climt_tpu/components/held_suarez.py:87-95)."""
    rng = np.random.RandomState(seed)
    ps = 1e5 + 2e3 * rng.randn(ncol)
    sigma = np.linspace(0.05, 0.98, nz)
    return (20.0 * rng.randn(ncol, nz), 5.0 * rng.randn(ncol, nz),
            220.0 + 80.0 * rng.rand(ncol, nz), ps[:, None] * sigma, ps,
            np.linspace(-88.0, 88.0, ncol))


HS_PARAMS = (0.7, 1 / 86400., 1 / 40. / 86400., 1 / 4. / 86400., 60.0, 10.0,
             1e5, 287.0 / 1004.0)


def test_held_suarez_forcing_takes_latitude_in_degrees():
    fields = _hs_inputs()
    outs_j = JH.held_suarez_forcing(*map(jnp.asarray, fields), *HS_PARAMS)
    outs_t = TH.held_suarez_forcing(
        *(torch.as_tensor(x) for x in fields), *HS_PARAMS)
    for a, b in zip(outs_t, outs_j):
        assert a.shape == b.shape
        assert rel_err(a, b) <= 1e-13


# -- bucket_step with JAX's flags --------------------------------------------

def _bucket_inputs(ncol=16, seed=6):
    rng = np.random.RandomState(seed)

    def u(lo, hi):
        return lo + (hi - lo) * rng.rand(ncol)

    fields = (u(250, 400), u(50, 900), u(300, 500), u(10, 200),
              u(270, 310), u(1200, 1600), u(0.05, 0.2), u(800, 1200),
              u(0.0, 0.2), u(0, 2e-7), u(0, 2e-7), u(0.002, 0.02),
              u(0.005, 0.025), u(265, 305), u(9e4, 1.02e5), u(-8, 8),
              u(-8, 8), u(0.1, 0.6), u(270, 300))
    scalars = (900.0, 0.15, 0.75, 2260000.0, 0.0011, 287.0, 1004.0, 1000.0,
               0.5, 5 * 86400.0, 10.0)
    return fields, scalars


@pytest.mark.parametrize('two_layer,have_tau_drain', [
    (False, False), (False, True), (True, False), (True, True)])
def test_bucket_step_with_jax_flags_matches_jax(two_layer, have_tau_drain):
    """JAX's exact argument list (bucket_hydrology.py:207-232): ten
    outputs, zeros for the deep store of one layer."""
    fields, scalars = _bucket_inputs()
    tau_drain = 20 * 86400.0
    outs_j = JB.bucket_step(*map(jnp.asarray, fields), *scalars, tau_drain,
                            two_layer, have_tau_drain)
    outs_t = TB.bucket_step(*(torch.as_tensor(x) for x in fields), *scalars,
                            tau_drain, two_layer, have_tau_drain)
    assert len(outs_t) == len(outs_j) == 10
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13,
                                   atol=0)


@pytest.mark.parametrize('layers,drain', [(1, False), (2, False), (2, True)])
def test_bucket_step_without_flags_keeps_the_none_rule(layers, drain):
    """w_deep None is one layer, tau_drain None no drainage: JAX's ten
    results for the flags that rule stands for."""
    fields, scalars = _bucket_inputs()
    tau_drain = 20 * 86400.0
    outs_j = JB.bucket_step(*map(jnp.asarray, fields), *scalars, tau_drain,
                            layers == 2, drain)
    t_fields = [torch.as_tensor(x) for x in fields]
    if layers == 1:
        t_fields[17] = t_fields[18] = None
    outs_t = TB.bucket_step(*t_fields, *scalars,
                            tau_drain if drain else None)
    assert len(outs_t) == 10
    for a, b in zip(outs_t, outs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-13,
                                   atol=0)


# -- DistributedSHT's placements ---------------------------------------------

def test_dist_sht_placements_rebuild_the_global_fields(tmp_path):
    """DTensor.from_local of a rank's grid block with grid_sharding() and
    of its spectral block with spec_sharding() gives the global field
    (M padded), on a gloo world of one; the placements are those of
    parallel.grid_sharding."""
    rng = np.random.RandomState(1)
    grid = torch.as_tensor(rng.randn(3, 16, 32))
    sht = SphericalHarmonicTransform(32, 16, dtype=torch.float64,
                                     device='cpu')
    with world_of_one(tmp_path):
        mesh = make_mesh(1, device='cpu')
        dsht = DistributedSHT(sht, mesh)
        assert dsht.grid_sharding() == grid_sharding(mesh)
        assert dsht.spec_sharding() == dsht.grid_sharding()
        spec = dsht.pad_spec(sht.analyze(grid))
        g = DTensor.from_local(grid[:, dsht.rows], mesh,
                               dsht.grid_sharding())
        s = DTensor.from_local(spec[:, dsht.m_rows], mesh,
                               dsht.spec_sharding())
        assert torch.equal(g.full_tensor(), grid)
        assert torch.equal(s.full_tensor(), spec)
