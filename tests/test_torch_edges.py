"""The port's edge classes against the JAX package's, one edge at a time:
``LinearMasked``, ``LinearMemory``, ``LinearFilter``, ``LinearMemoryFilter``
and every read of ``LinearMemoryMatrix`` (onehot, factored, gather, interp
with its hat and factored2 forms, ``read_dtype``, ``fine_s``, the env knobs,
the square weight/delay pairing and the validation).

Each case mirrors the ``tests/test_edges.py`` case it names: the same
seeded numpy inputs go through both packages at float64, the port is held
to the reference test's oracle with its tolerance, and to the JAX edge;
where the reference holds the reads equal bit for bit
(``assert_array_equal``), so does the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rectipy_tpu.edges as jedges
import rectipy_tpu_torch.edges as tedges

accuracy = 1e-4  # tests/test_edges.py's


def _pair(cls, *args, **kw):
    """The same edge in both packages, float64 (the port's on the CPU)."""
    return (getattr(jedges, cls)(*args, dtype=jnp.float64, **kw),
            getattr(tedges, cls)(*args, dtype=torch.float64, device="cpu", **kw))


def _fwd(edge, x):
    y = edge.forward(jnp.asarray(x) if isinstance(edge, jedges.Linear) else x)
    return np.asarray(y) if isinstance(edge, jedges.Linear) else y.numpy()


def test_linear_masked():
    # test_edges.py:60
    n, m = 6, 3
    rng = np.random.default_rng(1)
    w = rng.normal(size=(m, n))
    mask = (rng.random(size=(m, n)) > 0.5).astype(float)
    j, t = _pair("LinearMasked", n, m, mask=mask, weights=w, detach=False)
    x = rng.normal(size=(n,))
    np.testing.assert_allclose(_fwd(t, x), (w * mask) @ x, atol=accuracy)
    np.testing.assert_allclose(_fwd(t, x), _fwd(j, x), rtol=1e-12)
    assert t.train_keys == j.train_keys == ["weights"]  # mask stays frozen
    # the mask follows the weights' transpose rule
    _, tT = _pair("LinearMasked", n, m, mask=mask.T, weights=w.T)
    np.testing.assert_array_equal(tT.mask.numpy(), mask)
    with pytest.raises(ValueError, match="mask"):
        tedges.LinearMasked(n, m, mask=np.ones((n + 1, m)), device="cpu")


def test_linear_memory_delays():
    # test_edges.py:71 -- per-source delays: x[i] arrives delays[i] steps later
    delays = np.array([0, 1, 2])
    j, t = _pair("LinearMemory", 3, 3, delays=delays, weights=np.eye(3))
    outs = {}
    for e in (j, t):
        outs[e] = [_fwd(e, np.ones(3))] + [_fwd(e, np.zeros(3)) for _ in range(3)]
    np.testing.assert_allclose(outs[t][0], [1.0, 0.0, 0.0])
    np.testing.assert_allclose(outs[t][1], [0.0, 1.0, 0.0])
    np.testing.assert_allclose(outs[t][2], [0.0, 0.0, 1.0])
    np.testing.assert_allclose(outs[t][3], [0.0, 0.0, 0.0])
    np.testing.assert_array_equal(np.stack(outs[t]), np.stack(outs[j]))
    np.testing.assert_array_equal(t.buffer.numpy(), np.asarray(j.buffer))
    with pytest.raises(ValueError):
        tedges.LinearMemory(3, 3, delays=np.array([0, 1]), device="cpu")


def test_linear_memory_keeps_each_sources_history():
    # rectipy_tpu/edges.py:15-20: each source writes its own row (RectiPy's
    # broadcast write would clobber the others); random inputs, both packages
    rng = np.random.default_rng(4)
    n, m, T = 4, 3, 12
    delays = np.array([3, 0, 2, 1])
    W = rng.normal(size=(m, n))
    xs = rng.normal(size=(T, n))
    j, t = _pair("LinearMemory", n, m, delays=delays, weights=W)
    got = np.stack([_fwd(t, x) for x in xs])
    want = np.stack([_fwd(j, x) for x in xs])
    oracle = np.stack([W @ np.array([xs[s - d, i] if s >= d else 0.0
                                     for i, d in enumerate(delays)]) for s in range(T)])
    np.testing.assert_allclose(got, oracle, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_linear_filter():
    # test_edges.py:91 -- y_state <- F @ y_state + x ; out = W @ y_state
    n, m = 4, 2
    rng = np.random.default_rng(2)
    F = rng.normal(size=(n, n)) * 0.1
    w = rng.normal(size=(m, n))
    j, t = _pair("LinearFilter", n, m, filter_weights=F, weights=w)
    x1, x2 = rng.normal(size=(n,)), rng.normal(size=(n,))
    y1, y2 = _fwd(t, x1), _fwd(t, x2)
    ys = F @ np.zeros(n) + x1
    np.testing.assert_allclose(y1, w @ ys, atol=accuracy)
    ys = F @ ys + x2
    np.testing.assert_allclose(y2, w @ ys, atol=accuracy)
    np.testing.assert_allclose(np.stack([y1, y2]), np.stack([_fwd(j, x1), _fwd(j, x2)]),
                               rtol=1e-12)
    np.testing.assert_allclose(t.y.numpy(), np.asarray(j.y), rtol=1e-12)
    # trains the filter by default when trainable, as the JAX edge
    _, tt = _pair("LinearFilter", n, m, filter_weights=F, weights=w, detach=False)
    jt = jedges.LinearFilter(n, m, filter_weights=F, weights=w, detach=False)
    assert tt.train_keys == jt.train_keys == ["weights", "filter"]
    with pytest.raises(ValueError):
        tedges.LinearFilter(n, m, filter_weights=np.zeros((n + 1, n)), device="cpu")


def test_linear_memory_filter():
    # test_edges.py:111 -- the written 1.0 reaches slot 0 filtered by F once
    n = 3
    F = np.eye(n) * 0.5
    j, t = _pair("LinearMemoryFilter", n, n, delays=np.array([1, 1, 1]), filter_weights=F,
                 weights=np.eye(n))
    for e in (j, t):
        np.testing.assert_allclose(_fwd(e, np.ones(n)), 0.0, atol=accuracy)
        np.testing.assert_allclose(_fwd(e, np.zeros(n)), 0.5, atol=accuracy)
    # random delays, filter and inputs: both packages agree
    rng = np.random.default_rng(8)
    F = rng.normal(size=(n, n)) * 0.3
    W = rng.normal(size=(n, n))
    j, t = _pair("LinearMemoryFilter", n, n, delays=np.array([2, 0, 3]), filter_weights=F,
                 weights=W)
    for x in rng.normal(size=(10, n)):
        np.testing.assert_allclose(_fwd(t, x), _fwd(j, x), rtol=1e-12, atol=1e-14)
    assert t.train_keys == []


def _history_oracle(W, D, xs):
    """y_i(t) = sum_j W_ij x_j(t - D_ij) (test_edges.py:177's brute force)."""
    T, (n_out, n_in) = len(xs), W.shape
    want = np.zeros((T, n_out))
    for s in range(T):
        for i in range(n_out):
            for j in range(n_in):
                if s - D[i, j] >= 0:
                    want[s, i] += W[i, j] * xs[s - D[i, j], j]
    return want


def test_linear_memory_matrix_oracle():
    # test_edges.py:177
    rng = np.random.default_rng(7)
    n_in, n_out, T = 4, 3, 12
    W = rng.normal(size=(n_out, n_in))
    D = rng.integers(0, 5, size=(n_out, n_in))
    xs = rng.normal(size=(T, n_in))
    j, t = _pair("LinearMemoryMatrix", n_in, n_out, delays=D, weights=W)
    assert t.max_delay == j.max_delay == int(D.max())
    got = np.stack([_fwd(t, x) for x in xs])
    np.testing.assert_allclose(got, _history_oracle(W, D, xs), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(got, np.stack([_fwd(j, x) for x in xs]), rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_array_equal(t.buffer.numpy(), np.asarray(j.buffer))


def test_linear_memory_matrix_reduces_to_per_source():
    # test_edges.py:202 -- d_ij = d_j equals LinearMemory (square matrices are
    # given as (source, target): per-source delays constant along the rows)
    rng = np.random.default_rng(3)
    n = 5
    W = rng.normal(size=(n, n))
    d_src = np.array([0, 2, 1, 3, 0])
    D = np.tile(d_src[:, None], (1, n))
    m_edge = tedges.LinearMemoryMatrix(n, n, delays=D, weights=W, dtype=torch.float64,
                                       device="cpu")
    s_edge = tedges.LinearMemory(n, n, delays=d_src, weights=W, dtype=torch.float64,
                                 device="cpu")
    for _ in range(8):
        x = rng.normal(size=n)
        np.testing.assert_allclose(_fwd(m_edge, x), _fwd(s_edge, x), rtol=1e-6)


def test_linear_memory_matrix_validation():
    # test_edges.py:221
    def mm(*args, **kw):
        return tedges.LinearMemoryMatrix(*args, device="cpu", **kw)

    with pytest.raises(ValueError):  # 1-D delays belong to LinearMemory
        mm(3, 3, delays=np.array([0, 1, 2]))
    with pytest.raises(ValueError):  # shape mismatch
        mm(3, 2, delays=np.zeros((3, 3), dtype=int))
    with pytest.raises(ValueError):  # negative delays
        mm(2, 2, delays=np.array([[0, -1], [0, 0]]))
    with pytest.raises(ValueError):  # no diagonal (1-D weight) form
        mm(3, 3, delays=np.zeros((3, 3), dtype=int), weights=np.ones(3))
    # rectangular (n_in, n_out) delay matrix auto-transposes like weights
    e = mm(3, 2, delays=np.arange(6).reshape(3, 2), weights=np.ones((2, 3)))
    assert tuple(e.delays.shape) == (2, 3)
    with pytest.raises(ValueError):  # non-integral floats must be explicit
        mm(2, 2, delays=np.array([[0.0, 1.7], [1.0, 0.0]]))
    assert mm(2, 2, delays=np.array([[0.0, 2.0], [1.0, 0.0]])).max_delay == 2
    with pytest.raises(ValueError, match="mode"):
        mm(2, 2, delays=np.zeros((2, 2), dtype=int), mode="banana")


def test_linear_memory_matrix_square_weight_delay_pairing():
    # test_edges.py:244 -- square W and D given in the same (source, target)
    # layout pair per connection: y_i = sum_j W[j, i] x_j(t - D[j, i])
    rng = np.random.default_rng(21)
    n, T = 4, 12
    W = rng.normal(size=(n, n))
    D = rng.integers(0, 5, size=(n, n))
    xs = rng.normal(size=(T, n))
    j, t = _pair("LinearMemoryMatrix", n, n, delays=D, weights=W)
    got = np.stack([_fwd(t, x) for x in xs])
    np.testing.assert_allclose(got, _history_oracle(W.T, D.T, xs), rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(got, np.stack([_fwd(j, x) for x in xs]), rtol=1e-12,
                               atol=1e-14)


def test_linear_memory_matrix_modes_identical(monkeypatch):
    # test_edges.py:269 -- onehot and factored equal the gather bit for bit
    rng = np.random.default_rng(13)
    n_in, n_out, T = 5, 4, 40
    W = rng.normal(size=(n_out, n_in))
    D = rng.integers(0, 23, size=(n_out, n_in))
    modes = ("gather", "onehot", "factored")
    edges = {m: _pair("LinearMemoryMatrix", n_in, n_out, delays=D, weights=W, mode=m)
             for m in modes}
    assert all(t.mode == m for m, (_, t) in edges.items())
    assert edges["factored"][1].buffer.shape[1] >= int(D.max()) + 1  # Q*S pad
    assert edges["factored"][1].buffer.shape == edges["factored"][0].buffer.shape
    for _ in range(T):
        x = rng.normal(size=n_in)
        ys = {m: _fwd(t, x) for m, (_, t) in edges.items()}
        np.testing.assert_array_equal(ys["gather"], ys["onehot"])
        np.testing.assert_array_equal(ys["gather"], ys["factored"])
        np.testing.assert_allclose(ys["gather"], _fwd(edges["gather"][0], x), rtol=1e-12,
                                   atol=1e-14)
    # auto: factored -> gather past RECTIPY_DELAY_FACTORED_LIMIT, as in JAX
    assert tedges.LinearMemoryMatrix(n_in, n_out, delays=D, device="cpu").mode == "factored"
    monkeypatch.setenv("RECTIPY_DELAY_FACTORED_LIMIT", "1")
    assert tedges.LinearMemoryMatrix(n_in, n_out, delays=D, device="cpu").mode == "gather"


def test_linear_memory_matrix_auto_picks_jax_mode_at_whole_brain_size():
    # the env knobs' defaults pick the same read as the JAX package at the
    # whole-brain cell's size: M=998, D1=1158 -> S=15, Q=78, factored
    M = 998
    D = np.zeros((M, M), dtype=np.int64)
    D[0, 1] = 1157
    for pkg in (jedges, tedges):
        kw = {} if pkg is jedges else {"device": "cpu", "dtype": torch.float32}
        e = pkg.LinearMemoryMatrix(M, M, delays=D, weights=np.zeros((M, M)), **kw)
        assert (e.mode, e._fQS, e._D1) == ("factored", (78, 15), 1158)
    e = tedges.LinearMemoryMatrix(M, M, delays=D, mode="interp", device="cpu",
                                  weights=np.zeros((M, M)), dtype=torch.float32)
    assert e._interp_impl == "factored2"  # M*M*D1 > 2^24


def _loss_fn(pkg, edge, xs, target=None):
    """sum_t |y(t) (- target)|^2 as a function of the delay matrix."""
    step = edge.make_step()

    def loss(d):
        p = {**edge.params, "delays": d}
        buf = edge.init_state() * 0.0
        tot = 0.0
        for x in xs:
            buf, y = step(buf, p, x)
            tot = tot + ((y - target) ** 2 if target is not None else y ** 2).sum()
        return tot

    return loss


def _grad(pkg, edge, xs, d0, target=None):
    if pkg == "jax":
        loss = _loss_fn(pkg, edge, [jnp.asarray(x) for x in xs], target)
        return np.asarray(jax.grad(loss)(jnp.asarray(d0)))
    loss = _loss_fn(pkg, edge, [torch.as_tensor(x) for x in xs], target)
    d = torch.as_tensor(d0).requires_grad_(True)
    return torch.autograd.grad(loss(d), d)[0].numpy()


def test_linear_memory_matrix_interp_mode():
    # test_edges.py:300 -- interp equals the one-hot read at integer delays;
    # d = 1.5 splits an impulse in halves; the delay gradient is the finite
    # difference and JAX's
    rng = np.random.default_rng(0)
    n = 4
    W = rng.normal(size=(n, n))
    D = rng.integers(0, 5, size=(n, n)).astype(float)
    e_i = tedges.LinearMemoryMatrix(n, n, delays=D, weights=W, mode="interp",
                                    dtype=torch.float64, device="cpu")
    e_o = tedges.LinearMemoryMatrix(n, n, delays=D.astype(int), weights=W, mode="onehot",
                                    dtype=torch.float64, device="cpu")
    for _ in range(12):
        x = rng.normal(size=n)
        np.testing.assert_allclose(_fwd(e_i, x), _fwd(e_o, x), atol=1e-12)
    for pkg_edge in _pair("LinearMemoryMatrix", 1, 1, delays=np.array([[1.5]]),
                          weights=np.array([[1.0]]), mode="interp"):
        outs = [float(_fwd(pkg_edge, np.array([1.0]))[0])]
        outs += [float(_fwd(pkg_edge, np.array([0.0]))[0]) for _ in range(3)]
        assert outs == [0.0, 0.5, 0.5, 0.0]

    j, t = _pair("LinearMemoryMatrix", 1, 1, delays=np.array([[1.5]]),
                 weights=np.array([[1.0]]), mode="interp")
    xs = np.sin(np.arange(10.0))[:, None]
    g = _grad("torch", t, xs, np.array([[1.5]]), target=0.3)
    loss = _loss_fn("torch", t, [torch.as_tensor(x) for x in xs], 0.3)
    fd = float((loss(torch.tensor([[1.5 + 1e-5]], dtype=torch.float64))
                - loss(torch.tensor([[1.5 - 1e-5]], dtype=torch.float64))) / 2e-5)
    np.testing.assert_allclose(g[0, 0], fd, atol=1e-4)
    np.testing.assert_allclose(g, _grad("jax", j, xs, np.array([[1.5]]), target=0.3),
                               rtol=1e-12)

    def mm(*args, **kw):
        return tedges.LinearMemoryMatrix(*args, device="cpu", **kw)

    with pytest.raises(ValueError):  # train_delays needs a trainable edge
        mm(2, 2, delays=np.ones((2, 2)), train_delays=True)
    with pytest.raises(ValueError):  # max_delay headroom
        mm(2, 2, delays=np.full((2, 2), 3.0), mode="interp", max_delay=2)
    with pytest.raises(ValueError):
        mm(2, 2, delays=np.ones((2, 2)), train_delays=True, mode="gather", detach=False)
    e = mm(2, 2, delays=np.ones((2, 2)), train_delays=True, detach=False)
    assert e.mode == "interp" and e.train_keys == ["weights", "delays"]


def test_linear_memory_matrix_interp_factored2_equals_hat(monkeypatch):
    # test_edges.py:356 -- value- and gradient-identical to the hat
    rng = np.random.default_rng(2)
    n = 5
    W = rng.normal(size=(n, n))
    D = rng.uniform(0.0, 6.0, size=(n, n))
    kw = dict(delays=D, weights=W, mode="interp", max_delay=7, dtype=torch.float64,
              device="cpu")
    e_hat = tedges.LinearMemoryMatrix(n, n, **kw)
    monkeypatch.setenv("RECTIPY_DELAY_HAT_LIMIT", "1")
    e_f2 = tedges.LinearMemoryMatrix(n, n, **kw)
    j_f2 = jedges.LinearMemoryMatrix(n, n, delays=D, weights=W, mode="interp", max_delay=7,
                                     dtype=jnp.float64)
    monkeypatch.delenv("RECTIPY_DELAY_HAT_LIMIT")
    assert e_hat._interp_impl == "hat" and e_f2._interp_impl == j_f2._interp_impl == "factored2"
    for _ in range(20):
        x = rng.normal(size=n)
        np.testing.assert_allclose(_fwd(e_hat, x), _fwd(e_f2, x), atol=1e-12)
    xs = rng.normal(size=(15, n))
    d0 = D + 0.3  # interior of the fractional intervals
    g_hat, g_f2 = _grad("torch", e_hat, xs, d0), _grad("torch", e_f2, xs, d0)
    np.testing.assert_allclose(g_f2, g_hat, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(g_f2, _grad("jax", j_f2, xs, d0), rtol=1e-9, atol=1e-12)


def test_linear_memory_matrix_read_dtype_and_fine_s(monkeypatch):
    # test_edges.py:408 -- a bf16 read is the history rounded once to bf16;
    # fine_s changes nothing; the env knobs mirror the kwargs
    rng = np.random.default_rng(17)
    n_in, n_out, T = 5, 4, 30
    W = rng.normal(size=(n_out, n_in))
    D = rng.integers(0, 23, size=(n_out, n_in))
    xs = rng.normal(size=(T, n_in))
    for mode in ("factored", "onehot"):
        j, t = _pair("LinearMemoryMatrix", n_in, n_out, delays=D, weights=W, mode=mode,
                     read_dtype="bfloat16")
        assert t._sel_dtype == torch.bfloat16
        hist = np.zeros((n_in, int(D.max()) + 1))
        for x in xs:
            hist = np.concatenate([x[:, None], hist[:, :-1]], axis=1)
            vals = np.take_along_axis(hist, D.T, axis=1)
            vals_bf16 = torch.as_tensor(vals).to(torch.bfloat16).double().numpy()
            got = _fwd(t, x)
            np.testing.assert_allclose(got, np.einsum("ij,ji->i", W, vals_bf16), rtol=1e-12,
                                       atol=1e-12)
            np.testing.assert_allclose(got, _fwd(j, x), rtol=1e-12, atol=1e-12)
    for S in (1, 2, 7, int(D.max()) + 1):
        e = tedges.LinearMemoryMatrix(n_in, n_out, delays=D, weights=W, mode="factored",
                                      fine_s=S, dtype=torch.float64, device="cpu")
        ref = tedges.LinearMemoryMatrix(n_in, n_out, delays=D, weights=W, mode="gather",
                                        dtype=torch.float64, device="cpu")
        assert e._fQS[1] == S
        for x in xs[:10]:
            np.testing.assert_array_equal(_fwd(e, x), _fwd(ref, x))
    monkeypatch.setenv("RECTIPY_DELAY_FINE_S", "3")
    monkeypatch.setenv("RECTIPY_DELAY_READ_DTYPE", "bfloat16")
    e = tedges.LinearMemoryMatrix(n_in, n_out, delays=D, weights=W, mode="factored",
                                  device="cpu")
    assert e._fQS[1] == 3 and e.read_dtype == torch.bfloat16
    monkeypatch.delenv("RECTIPY_DELAY_FINE_S")
    monkeypatch.delenv("RECTIPY_DELAY_READ_DTYPE")
    with pytest.raises(ValueError):
        tedges.LinearMemoryMatrix(n_in, n_out, delays=D, read_dtype=torch.int8, device="cpu")
    with pytest.raises(ValueError):
        tedges.LinearMemoryMatrix(n_in, n_out, delays=D, fine_s=0, device="cpu")
    # interp factored2 with a bf16 read: a blend of bf16 reads, f full width
    Df = D.astype(float) + 0.25
    kw = dict(delays=Df, weights=W, mode="interp", max_delay=int(D.max()) + 1)
    monkeypatch.setenv("RECTIPY_DELAY_HAT_LIMIT", "1")
    j, t = _pair("LinearMemoryMatrix", n_in, n_out, read_dtype="bfloat16", **kw)
    monkeypatch.delenv("RECTIPY_DELAY_HAT_LIMIT")
    t_ref = tedges.LinearMemoryMatrix(n_in, n_out, dtype=torch.float64, device="cpu", **kw)
    assert t._interp_impl == j._interp_impl == "factored2"
    for x in xs[:10]:
        a = _fwd(t, x)
        np.testing.assert_allclose(a, _fwd(t_ref, x), rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(a, _fwd(j, x), rtol=1e-12, atol=1e-12)


def test_interp_impl_override_bit_identical():
    # test_edges.py:676 -- hat and factored2 forced per edge, through the
    # prep pass, as the network runs them
    rng = np.random.default_rng(5)
    n, m, T = 4, 3, 30
    d = rng.uniform(0.0, 6.0, size=(n, m))
    W = rng.standard_normal((n, m))
    xs = rng.standard_normal((T, m))
    outs = {}
    for impl in ("hat", "factored2"):
        j, t = _pair("LinearMemoryMatrix", m, n, delays=d, weights=W, mode="interp",
                     max_delay=8, interp_impl=impl)
        assert t._interp_impl == impl
        for pkg, e in (("jax", j), ("torch", t)):
            state, step = e.init_state(), e.make_step()
            prep = e.prep_params(dict(e.params))
            ys = []
            for x in xs:
                state, y = step(state, prep, jnp.asarray(x) if pkg == "jax"
                                else torch.as_tensor(x))
                ys.append(np.asarray(y))
            outs[impl, pkg] = np.stack(ys)
        assert t.selector_builds == 1  # the prep pass alone
    np.testing.assert_allclose(outs["factored2", "torch"], outs["hat", "torch"], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(outs["hat", "torch"], outs["hat", "jax"], rtol=1e-12,
                               atol=1e-12)
    with pytest.raises(ValueError, match="interp_impl"):
        tedges.LinearMemoryMatrix(m, n, delays=d, weights=W, mode="interp", max_delay=8,
                                  interp_impl="nope", device="cpu")


@pytest.mark.parametrize("mode", ["onehot", "factored", "gather", "hat", "factored2"])
def test_delay_matrix_steps_take_leading_trial_axes(mode):
    # a (B, n_in, width) buffer and (B, n_in) inputs: each trial equals its
    # own single-trial run (shared selectors), and per-trial delays (a swept
    # interp matrix, (B, n_out, n_in)) equal single-trial edges of those delays
    rng = np.random.default_rng(30)
    n_in, n_out, B, T = 5, 3, 3, 12
    W = rng.normal(size=(n_out, n_in))
    interp = mode in ("hat", "factored2")
    D = rng.uniform(0, 6, size=(n_out, n_in)) if interp else rng.integers(0, 7, (n_out, n_in))
    kw = (dict(mode="interp", interp_impl=mode, max_delay=7) if interp else dict(mode=mode))
    e = tedges.LinearMemoryMatrix(n_in, n_out, delays=D, weights=W, dtype=torch.float64,
                                  device="cpu", **kw)
    xs = torch.as_tensor(rng.normal(size=(T, B, n_in)))
    step = e.make_step()
    params = e.prep_params(dict(e.params))
    buf = e.init_state().expand(B, *e.init_state().shape).contiguous()
    ys = []
    for x in xs:
        buf, y = step(buf, params, x)
        ys.append(y)
    ys = torch.stack(ys, 1).numpy()
    for b in range(B):
        single = tedges.LinearMemoryMatrix(n_in, n_out, delays=D, weights=W,
                                           dtype=torch.float64, device="cpu", **kw)
        np.testing.assert_array_equal(ys[b], np.stack([_fwd(single, x) for x in xs[:, b]]))
    if not interp:
        return
    Ds = rng.uniform(0, 6, size=(B, n_out, n_in))
    params = e.prep_params({**e.params, "delays": torch.as_tensor(Ds)})
    buf = torch.zeros(B, *e.init_state().shape, dtype=torch.float64)
    ys = []
    for x in xs:
        buf, y = step(buf, params, x)
        ys.append(y)
    ys = torch.stack(ys, 1).numpy()
    for b in range(B):
        single = tedges.LinearMemoryMatrix(n_in, n_out, delays=Ds[b], weights=W,
                                           dtype=torch.float64, device="cpu", **kw)
        np.testing.assert_allclose(ys[b], np.stack([_fwd(single, x) for x in xs[:, b]]),
                                   rtol=1e-12, atol=1e-14)


def test_every_buffer_and_state_matches_the_jax_layout():
    # convert.load_jax_params carries states one to one: the same shapes
    rng = np.random.default_rng(6)
    n, m = 4, 3
    W = rng.normal(size=(m, n))
    cases = [("LinearMemory", dict(delays=np.array([0, 3, 1, 2]))),
             ("LinearMemoryFilter", dict(delays=np.array([0, 3, 1, 2]),
                                         filter_weights=np.eye(n) * 0.3)),
             ("LinearFilter", dict(filter_weights=np.eye(n) * 0.3)),
             ("LinearSTP", dict(dt=1e-2, tau_facil=3.0, tau_depress=2.0))]
    cases += [("LinearMemoryMatrix", dict(delays=rng.integers(0, 30, (m, n)), mode=mode))
              for mode in ("onehot", "factored", "gather")]
    cases += [("LinearMemoryMatrix", dict(delays=rng.uniform(0, 30, (m, n)), mode="interp",
                                          interp_impl=impl)) for impl in ("hat", "factored2")]
    for cls, kw in cases:
        j, t = _pair(cls, n, m, weights=W, **kw)
        js, ts = j.init_state(), t.init_state()
        if isinstance(js, tuple):
            assert isinstance(ts, tuple) and len(ts) == len(js)
        else:
            js, ts = (js,), (ts,)
        for a, b in zip(js, ts):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        assert sorted(t.params) == sorted(j.params), cls
