"""The port's densification (`gaussian_splatting_torch/scene/densify.py`):
the host form against the JAX package's numpy form (bit-equal on the same
inputs and the same `np.random.Generator` seed), the analogs of
tests/test_densify.py's cases, and the in-place device form at fixed
capacity on the CPU.

The device form draws its split samples from a `torch.Generator`, so it is
held to the host form as a set of rows: the split children's xyz taken
from the same seeded draw, every other value equal (log-scales of split
children within rtol 1e-6: torch's exp and log against numpy's). It is
held to JAX's device form slot by slot on a state whose live rows are
scattered among dead ones: counts, `alive`, moments and parameters bit for
bit, but for the split children's xyz (each package's own draw) and
log-scales (within 1e-6).
"""

import numpy as np
import pytest
import torch

from gaussian_splatting_tpu.scene import densify as jdensify
from gaussian_splatting_torch import init_train_state
from gaussian_splatting_torch.ops import gsmath
from gaussian_splatting_torch.scene import densify
from gaussian_splatting_torch.scene.gaussians import PARAM_NAMES, params_from_numpy
from gaussian_splatting_torch.training import train_state_from_numpy

HOST_KW = dict(max_grad=0.5, min_opacity=0.005, extent=1.0, percent_dense=0.01)


def _mk_params(P, scale_log=-3.0):
    return {
        "xyz": np.random.default_rng(0).normal(size=(P, 3)).astype(np.float32),
        "features_dc": np.zeros((P, 1, 3), np.float32),
        "features_rest": np.zeros((P, 15, 3), np.float32),
        "scaling": np.full((P, 3), scale_log, np.float32),
        "rotation": np.tile(np.array([1, 0, 0, 0], np.float32), (P, 1)),
        "opacity": np.full((P, 1), 2.0, np.float32),  # sigmoid(2) ~ 0.88
    }


def _mk_moments(params):
    return (
        {k: np.ones_like(v) for k, v in params.items()},
        {k: np.ones_like(v) for k, v in params.items()},
    )


# ---------------------------------------------------------------------------
# the host form: analogs of tests/test_densify.py:26-125
# ---------------------------------------------------------------------------


def test_clone_small_high_grad():
    P = 10
    params = _mk_params(P, scale_log=-5.0)  # tiny scales -> clone path
    m, v = _mk_moments(params)
    grads = np.zeros(P, np.float32)
    grads[:3] = 1.0
    res = densify.densify_and_prune(params, m, v, grads, np.ones(P), np.zeros(P),
                                    max_screen_size=None, rng=np.random.default_rng(1), **HOST_KW)
    assert res.n_cloned == 3 and res.n_split == 0 and res.n_pruned == 0
    assert res.params["xyz"].shape[0] == P + 3
    np.testing.assert_array_equal(res.params["xyz"][P:], params["xyz"][:3])
    assert (res.adam_m["xyz"][P:] == 0).all()
    assert (res.adam_m["xyz"][:P] == 1).all()


def test_split_large_high_grad():
    P = 8
    params = _mk_params(P, scale_log=0.0)  # scale 1.0 > 0.01 * extent -> split
    m, v = _mk_moments(params)
    grads = np.zeros(P, np.float32)
    grads[:2] = 1.0
    res = densify.densify_and_prune(params, m, v, grads, np.ones(P), np.zeros(P),
                                    max_screen_size=None, rng=np.random.default_rng(1), **HOST_KW)
    assert res.n_split == 2 and res.n_cloned == 0
    assert res.params["xyz"].shape[0] == P - 2 + 4
    np.testing.assert_allclose(np.exp(res.params["scaling"][P - 2:]), 1.0 / 1.6, rtol=1e-5)


def test_prune_low_opacity():
    P = 6
    params = _mk_params(P, scale_log=-5.0)
    params["opacity"][:2] = -10.0
    m, v = _mk_moments(params)
    res = densify.densify_and_prune(params, m, v, np.zeros(P), np.ones(P), np.zeros(P),
                                    max_screen_size=None, rng=np.random.default_rng(1), **HOST_KW)
    assert res.n_pruned == 2
    assert res.params["xyz"].shape[0] == P - 2


def test_prune_world_size():
    P = 6
    params = _mk_params(P, scale_log=-5.0)
    params["scaling"][0] = 2.0  # exp(2) ~ 7.4 > 0.1 * extent
    m, v = _mk_moments(params)
    res = densify.densify_and_prune(params, m, v, np.zeros(P), np.ones(P), np.zeros(P),
                                    max_screen_size=20, rng=np.random.default_rng(1), **HOST_KW)
    assert res.n_pruned == 1


def test_reset_opacity():
    params = _mk_params(4)
    params["opacity"][:] = 3.0
    m, v = _mk_moments(params)
    p2, m2, v2 = densify.reset_opacity(params, m, v)
    np.testing.assert_allclose(1 / (1 + np.exp(-p2["opacity"])), 0.01, rtol=1e-4)
    assert (m2["opacity"] == 0).all() and (v2["opacity"] == 0).all()
    assert (m2["xyz"] == 1).all()


# ---------------------------------------------------------------------------
# the host form and the reset bit-equal to JAX's
# ---------------------------------------------------------------------------


def random_live_state(P=200, seed=3):
    """Live rows on which clone, split, the opacity prune and the size prune
    all fire (with extent 1, percent_dense 0.01, threshold 0.5)."""
    rng = np.random.default_rng(seed)
    params = {
        "xyz": rng.normal(size=(P, 3)).astype(np.float32),
        "features_dc": rng.normal(size=(P, 1, 3)).astype(np.float32),
        "features_rest": rng.normal(size=(P, 15, 3)).astype(np.float32),
        # log-scales around log(0.01): some clone, some split, a few huge
        "scaling": rng.normal(np.log(0.01), 1.0, (P, 3)).astype(np.float32),
        "rotation": rng.normal(size=(P, 4)).astype(np.float32),
        "opacity": rng.normal(0.0, 3.0, (P, 1)).astype(np.float32),
    }
    params["scaling"][:8] = 0.5  # exp(0.5) > 0.1: size-pruned when the size test is on
    m = {k: rng.normal(size=x.shape).astype(np.float32) for k, x in params.items()}
    v = {k: rng.uniform(size=x.shape).astype(np.float32) for k, x in params.items()}
    stats = {
        "xyz_grad_accum": rng.uniform(0, 2, P).astype(np.float32),
        "denom": rng.integers(0, 3, P).astype(np.float32),
        "max_radii2d": rng.uniform(0, 30, P).astype(np.float32),
    }
    return params, m, v, stats


@pytest.mark.parametrize("max_screen_size", [None, 20])
def test_host_form_is_bit_equal_to_jax(max_screen_size):
    params, m, v, st = random_live_state()
    outs = []
    for mod in (jdensify, densify):
        outs.append(mod.densify_and_prune(
            params, m, v, st["xyz_grad_accum"], st["denom"], st["max_radii2d"],
            max_screen_size=max_screen_size, rng=np.random.default_rng(11), **HOST_KW))
    want, got = outs
    assert got.n_cloned > 0 and got.n_split > 0 and got.n_pruned > 0
    assert (got.n_cloned, got.n_split, got.n_pruned) == (want.n_cloned, want.n_split, want.n_pruned)
    for name in ("params", "adam_m", "adam_v"):
        for k in PARAM_NAMES:
            a, b = getattr(got, name)[k], getattr(want, name)[k]
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f"{name}[{k}]")
    p2, m2, v2 = densify.reset_opacity(got.params, got.adam_m, got.adam_v)
    jp2, jm2, jv2 = jdensify.reset_opacity(want.params, want.adam_m, want.adam_v)
    for got_d, want_d in ((p2, jp2), (m2, jm2), (v2, jv2)):
        for k in PARAM_NAMES:
            np.testing.assert_array_equal(got_d[k], want_d[k], err_msg=k)


# ---------------------------------------------------------------------------
# the device form at fixed capacity
# ---------------------------------------------------------------------------


def padded_state(params, m, v, cap, grad_accum=None, denom=None):
    """A port TrainState (CPU) of `cap` rows with the given live rows first."""
    live = params["xyz"].shape[0]

    def pad(a):
        out = np.zeros((cap,) + a.shape[1:], np.float32)
        out[:live] = a
        return out

    stat = lambda x: pad(np.zeros(live, np.float32) if x is None else x)  # noqa: E731
    return train_state_from_numpy(
        {k: pad(x) for k, x in params.items()}, {k: pad(x) for k, x in m.items()},
        {k: pad(x) for k, x in v.items()}, 0, np.arange(cap) < live,
        stat(None), stat(grad_accum), stat(denom), device="cpu")


def snapshot(state):
    out = {f"p.{k}": getattr(state.params, k).detach().clone() for k in PARAM_NAMES}
    out.update({f"m.{k}": state.adam.m[k].clone() for k in PARAM_NAMES})
    out.update({f"v.{k}": state.adam.v[k].clone() for k in PARAM_NAMES})
    out.update(alive=state.params.alive.clone(), grad=state.xyz_grad_accum.clone(),
               denom=state.denom.clone(), radii=state.max_radii2d.clone())
    return out


def gen(seed=0):
    return torch.Generator().manual_seed(seed)


def test_device_densify_clone_split_prune():
    """The analog of test_densify.py:130: index 0 clones, 1 splits, 2 is
    pruned, the rest survive untouched."""
    cap, live = 16, 8
    params = _mk_params(live, scale_log=-5.0)
    params["scaling"][1] = 1.0
    params["opacity"][2] = -10.0
    m, v = _mk_moments(params)
    grads = np.zeros(live, np.float32)
    grads[:2] = 1.0
    state = padded_state(params, m, v, cap, grads, np.ones(live, np.float32))
    counts = densify.densify_and_prune_device(state, gen(), use_size_prune=False, **HOST_KW)
    assert counts == {"n_cloned": 1, "n_split": 1, "n_pruned": 1, "overflow": 0}
    a2 = state.params.alive.numpy()
    assert a2.sum() == 9
    xyz = state.params.xyz.detach().numpy()
    for gone in (params["xyz"][1], params["xyz"][2]):
        assert (np.abs(xyz[a2] - gone).max(axis=1) > 0).all()
    assert (np.abs(xyz[a2] - params["xyz"][0]).max(axis=1) == 0.0).sum() == 2
    scaling = state.params.scaling.detach().numpy()
    child_rows = a2 & (np.abs(scaling[:, 0] - (1.0 - np.log(1.6))) < 1e-5)
    assert child_rows.sum() == 2
    assert (np.abs(xyz[child_rows] - params["xyz"][1]) > 0).any()
    m2 = state.adam.m["xyz"].numpy()
    new_rows = a2 & ~(np.arange(cap) < live)
    assert (m2[new_rows] == 0).all()
    assert (m2[3] == 1).all()


def test_device_densify_overflow_leaves_every_bit():
    """The analog of test_densify.py:178, extended to every field: with no
    free slot the edit is skipped and the state is bit for bit as it was."""
    params, m, v, st = random_live_state(P=64)
    state = padded_state(params, m, v, 64, st["xyz_grad_accum"], st["denom"])
    before = snapshot(state)
    counts = densify.densify_and_prune_device(state, gen(), use_size_prune=True, **HOST_KW)
    assert counts["overflow"] == 1
    after = snapshot(state)
    for k, x in before.items():
        assert torch.equal(after[k], x), k


def test_device_densify_reads_every_parent_before_writing():
    """The only free slots are the split originals' and the pruned rows',
    and the first children land in the slot of a later parent: each child
    must still carry its own parent's values."""
    cap = live = 8
    params = _mk_params(live, scale_log=-5.0)
    params["features_dc"][:, 0, 0] = np.arange(live)  # a parent's id in every child
    params["scaling"][:2] = 1.0  # rows 0 and 1 split (4 children)
    params["opacity"][2:4] = -10.0  # rows 2 and 3 pruned: 4 free slots in all
    m, v = _mk_moments(params)
    grads = np.zeros(live, np.float32)
    grads[:2] = 1.0
    state = padded_state(params, m, v, cap, grads, np.ones(live, np.float32))
    counts = densify.densify_and_prune_device(state, gen(), use_size_prune=False, **HOST_KW)
    assert counts == {"n_cloned": 0, "n_split": 2, "n_pruned": 2, "overflow": 0}
    assert bool(state.params.alive.all())
    # row 0's children take slots 0 and 1 (row 1 is a parent), row 1's 2 and 3
    parent = state.params.features_dc[:4, 0, 0].detach().numpy()
    np.testing.assert_array_equal(parent, [0, 0, 1, 1])
    np.testing.assert_allclose(state.params.scaling[:4].detach().numpy(), 1.0 - np.log(1.6),
                               rtol=1e-6)
    xyz = state.params.xyz.detach().numpy()
    for slot, src in enumerate([0, 0, 1, 1]):
        assert 0 < np.abs(xyz[slot] - params["xyz"][src]).max() < 10.0
    assert (state.adam.m["xyz"][:4] == 0).all() and (state.adam.m["xyz"][4:] == 1).all()


def rows_matrix(p, m, v):
    """Each live row as one float64 vector: parameters, then moments."""
    cols = [np.asarray(d[k], np.float64).reshape(len(d["xyz"]), -1)
            for d in (p, m, v) for k in PARAM_NAMES]
    mat = np.concatenate(cols, axis=1)
    return mat[np.lexsort(mat.T[::-1])]


@pytest.mark.parametrize("use_size_prune", [False, True])
def test_device_form_rows_equal_the_host_forms(use_size_prune):
    """The same edit as the host form on the live rows, with the split
    children's xyz recomputed from the device form's own seeded draw."""
    params, m, v, st = random_live_state(P=200)
    cap = 1024
    state = padded_state(params, m, v, cap, st["xyz_grad_accum"], st["denom"])
    counts = densify.densify_and_prune_device(state, gen(7), use_size_prune=use_size_prune,
                                              **HOST_KW)
    assert counts["overflow"] == 0 and counts["n_cloned"] > 0 and counts["n_split"] > 0
    res = densify.densify_and_prune(params, m, v, st["xyz_grad_accum"], st["denom"],
                                    st["max_radii2d"], max_screen_size=20 if use_size_prune else None,
                                    rng=np.random.default_rng(0), **HOST_KW)
    assert (res.n_cloned, res.n_split) == (counts["n_cloned"], counts["n_split"])

    # The host form's surviving split children are its last rows, two per
    # parent in index order; give them the device form's samples.
    eps = torch.randn((2, cap, 3), generator=gen(7))
    grads = np.where(st["denom"] > 0, st["xyz_grad_accum"] / np.maximum(st["denom"], 1), 0.0)
    scales = np.exp(params["scaling"])
    split = (grads >= 0.5) & (scales.max(axis=1) > 0.01)
    child_scales = scales / 1.6
    child_pruned = 1 / (1 + np.exp(-params["opacity"][:, 0])) < 0.005
    if use_size_prune:
        child_pruned |= child_scales.max(axis=1) > 0.1
    parents = np.nonzero(split & ~child_pruned)[0]
    q = torch.from_numpy(params["rotation"][parents])
    rot = gsmath.quat_to_rotmat(gsmath.normalize_quat(q))
    xyz = res.params["xyz"].copy()
    first = xyz.shape[0] - 2 * parents.size
    for j in range(2):
        off = torch.einsum("pij,pj->pi", rot, eps[j][parents] * torch.from_numpy(scales[parents]))
        xyz[first + j::2] = params["xyz"][parents] + off.numpy()
    want = rows_matrix(dict(res.params, xyz=xyz), res.adam_m, res.adam_v)

    alive = state.params.alive.numpy()
    got = rows_matrix({k: getattr(state.params, k).detach().numpy()[alive] for k in PARAM_NAMES},
                      {k: state.adam.m[k].numpy()[alive] for k in PARAM_NAMES},
                      {k: state.adam.v[k].numpy()[alive] for k in PARAM_NAMES})
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def scattered_state(cap, seed=3):
    """random_live_state's 200 rows with unit quaternions, placed at random
    slots of `cap` rows; the dead rows hold random values (as the slots a
    device densify pruned do). features_dc[:, 0, 0] is each live row's
    slot, so every child names its parent."""
    params, m, v, st = random_live_state()
    params["rotation"] /= np.linalg.norm(params["rotation"], axis=1, keepdims=True)
    rng = np.random.default_rng(seed)
    slots = np.sort(rng.choice(cap, params["xyz"].shape[0], replace=False))
    params["features_dc"][:, 0, 0] = slots

    def pad(x):
        out = rng.normal(size=(cap,) + x.shape[1:]).astype(np.float32)
        out[slots] = x
        return out

    alive = np.zeros(cap, bool)
    alive[slots] = True
    return ({k: pad(x) for k, x in params.items()}, {k: pad(x) for k, x in m.items()},
            {k: pad(x) for k, x in v.items()}, {k: pad(x) for k, x in st.items()}, alive)


def split_children(p, alive, params):
    """(slot, parent slot, j) of every split child in a densified state:
    live rows whose log-scales are not their parent's; a parent's children
    take free slots in j order."""
    out, seen = [], {}
    for s in np.nonzero(alive)[0]:
        i = int(p["features_dc"][s, 0, 0])
        if not np.array_equal(p["scaling"][s], params["scaling"][i]):
            out.append((s, i, seen.get(i, 0)))
            seen[i] = seen.get(i, 0) + 1
    return out


@pytest.mark.parametrize("use_size_prune,cap", [(False, 512), (True, 512), (True, 200)])
def test_device_form_equals_jax_device_form(use_size_prune, cap):
    """The same padded state, live rows scattered among dead ones, through
    JAX's device form and the port's: the same counts, `alive`, moments
    and parameters bit for bit, which fixes the slot each child takes; the
    split children's log-scales within 1e-6. Their xyz come from each
    package's own draw: each is held to its parent + R(q) (eps * scale)
    from that package's samples. At cap = 200 there is no dead slot and
    the edit overflows."""
    import jax

    from gaussian_splatting_tpu.scene.gaussians import GaussianParams

    params, m, v, st, alive = scattered_state(cap)
    jp, jm, jv, jalive, jcounts = jdensify.densify_and_prune_device(
        *(GaussianParams(**{k: d[k] for k in PARAM_NAMES}) for d in (params, m, v)),
        alive, st["xyz_grad_accum"], st["denom"], jax.random.PRNGKey(5),
        use_size_prune=use_size_prune, **HOST_KW)
    state = train_state_from_numpy(params, m, v, 0, alive, st["max_radii2d"],
                                   st["xyz_grad_accum"], st["denom"], device="cpu")
    counts = densify.densify_and_prune_device(state, gen(7), use_size_prune=use_size_prune,
                                              **HOST_KW)
    assert counts == {k: int(x) for k, x in jcounts.items()}
    assert counts["overflow"] == (cap == 200)
    if cap > 200:
        assert counts["n_cloned"] > 0 and counts["n_split"] > 0 and counts["n_pruned"] > 0
    got_alive = state.params.alive.numpy()
    np.testing.assert_array_equal(got_alive, np.asarray(jalive))
    got = {k: getattr(state.params, k).detach().numpy() for k in PARAM_NAMES}
    want = {k: np.asarray(x) for k, x in jp._asdict().items()}
    for k in PARAM_NAMES:
        np.testing.assert_array_equal(state.adam.m[k].numpy(), np.asarray(getattr(jm, k)), err_msg=k)
        np.testing.assert_array_equal(state.adam.v[k].numpy(), np.asarray(getattr(jv, k)), err_msg=k)
        if k not in ("xyz", "scaling"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    children = split_children(got, got_alive, params)
    assert children == split_children(want, got_alive, params)
    assert bool(children) == (cap > 200)
    per_parent = np.bincount([i for _, i, _ in children], minlength=cap)
    assert set(per_parent[per_parent > 0]) <= {2}  # both children of every split parent
    rest = np.ones(cap, bool)
    rest[[s for s, _, _ in children]] = False
    for k in ("xyz", "scaling"):
        np.testing.assert_array_equal(got[k][rest], want[k][rest], err_msg=k)
    # log(exp(s) / 1.6): torch's exp and log against XLA's, a few ulp apart
    np.testing.assert_allclose(got["scaling"][~rest], want["scaling"][~rest], rtol=0, atol=1e-6)
    eps_port = torch.randn((2, cap, 3), generator=gen(7)).numpy()
    eps_jax = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (2, cap, 3)))
    for out, eps in ((got, eps_port), (want, eps_jax)):
        for s, i, j in children:
            q = params["rotation"][i].astype(np.float64)
            rot = gsmath.quat_to_rotmat(torch.from_numpy(q[None]))[0].numpy()
            off = rot @ (eps[j, i] * np.exp(params["scaling"][i].astype(np.float64)))
            np.testing.assert_allclose(out["xyz"][s], params["xyz"][i] + off, rtol=0, atol=1e-5)


def test_device_densify_after_init_train_state():
    """A state made by init_train_state (alive from the module) densifies
    in place; nothing fires on zero statistics but the opacity prune."""
    params = _mk_params(6, scale_log=-5.0)
    params["opacity"][0] = -10.0
    gp = params_from_numpy(params, alive=np.ones(6, bool), device="cpu")
    state = init_train_state(gp)
    counts = densify.densify_and_prune_device(state, gen(), use_size_prune=False, **HOST_KW)
    assert counts == {"n_cloned": 0, "n_split": 0, "n_pruned": 1, "overflow": 0}
    np.testing.assert_array_equal(state.params.alive.numpy(), [False] + [True] * 5)
