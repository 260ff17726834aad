"""The port's (data, model) mesh on ``torch.distributed`` vs the JAX
package's ``parallel/``, on the CPU.

- ``make_mesh``: the grid shapes and the errors of JAX's on 4 devices;
- ``param_shardings``: for each family's tiny model (the other port tests'
  configs) at ``n_model`` 1, 2 and 4, the port splits the parameter that
  the bridge routes to each flax leaf on the dimension that JAX's rule
  splits that leaf on (JAX on 4 or 8 of conftest's virtual devices);
- gloo worlds of 2 ranks (a 1x2 mesh) and 4 ranks (2x2) through
  ``parallel/dryrun.py::dryrun_multichip`` (its own gates: below, and a
  falling loss with the FF's pinned dropout on), on the tiny LiteSATRN of ``test_torch_lite_satrn.py`` (decoder heads 2: split at
  n_model 2), bridged from seeded JAX weights, every dropout at 0 (one
  rank's generator cannot draw another's masks), labels of 1 to 5 tokens so
  that the shards hold different pad counts (a mean of the ranks' means
  would miss):

  - one global batch of 8 rows; both worlds run while the JAX side
    compiles;
  - 4 AdamW steps (clip 2.0) against JAX's ``make_sharded_train_step`` on
    the same mesh shape at ``test_torch_train_steps.py``'s tolerances
    (loss, grad norm rtol 1e-5 -- the grad norm and the weights against
    JAX's 1x2 mesh at 2x2 too, since JAX's 2x2 mesh computes gradients ~4e-4
    off its own single-device program; each parameter 2e-6 + 5% of the last
    step's learning rate, an element whose gradient stayed below 1e-5 of
    the step's largest twice the learning rates' sum; the synced BatchNorm
    statistics 1e-5 + 0.1 of that sum), and against the port's replay on
    a mesh of one rank in this process at rtol 1e-5 (the losses, as the
    JAX dry run holds them, and the grad norms);
  - greedy tokens through ``make_sharded_infer_fn`` (kernels 1-3's plain
    versions here) equal JAX's ``make_sharded_infer_fn``; the two-member
    ensemble's equal JAX's joint decode sharded over ``data``; the
    tensor-parallel tokens of the plain fast step and of the module step
    equal JAX's ``make_tp_infer_fn``; a kernel path under tensor
    parallelism raises;
- NCCL with more ranks on a host than cards raises;
- ``utils/system.py``: a CPU ``profile_trace`` file, the prints.
"""

import json
import os
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from p4fr_tpu.decoding.greedy import make_greedy_fn as jax_make_greedy_fn
from p4fr_tpu.infer.ensemble import make_ensemble_decode_fn
from p4fr_tpu.models.aster import aster_from_options as jax_aster_from_options
from p4fr_tpu.models.satrn import satrn_from_options as jax_satrn_from_options
from p4fr_tpu.models.swin import swin_from_options as jax_swin_from_options
from p4fr_tpu.parallel import mesh as jax_mesh
from p4fr_tpu.parallel import sharding as jax_sharding
from p4fr_tpu.train import schedules as jax_schedules
from p4fr_tpu.train import steps as jax_steps
from p4fr_tpu.utils.flags import Flags
from p4fr_tpu_torch.models.registry import get_network
from p4fr_tpu_torch.parallel import mesh
from p4fr_tpu_torch.parallel.dryrun import Case, dryrun_multichip
from p4fr_tpu_torch.train import schedules
from p4fr_tpu_torch.utils import system
from p4fr_tpu_torch.utils.convert import param_routes, state_dict_from_jax
from test_torch_aster import CONFIGS as ASTER_CONFIGS
from test_torch_lite_satrn import CONFIGS as LITE_CONFIGS
from test_torch_slice import CONFIGS as SATRN_CONFIGS
from test_torch_slice import seeded_variables
from test_torch_swin import CONFIGS as SWIN_CONFIGS
from test_torch_train_steps import assert_state_matches

STEPS, DECODE = 4, 6
FAMILIES = {"LiteSATRN": (jax_satrn_from_options, LITE_CONFIGS),
            "EfficientSATRN": (jax_satrn_from_options, SATRN_CONFIGS),
            "SWIN": (jax_swin_from_options, SWIN_CONFIGS),
            "EfficientASTER": (jax_aster_from_options, ASTER_CONFIGS)}


def jax_model(network, seed, vocab, ff_dropout=None):
    build, configs = FAMILIES[network]
    jmodel = build(Flags(configs).get(), len(vocab), vocab.pad_id, vocab.sos_id,
                   dtype=jnp.float32)
    if ff_dropout is not None:
        jmodel = jmodel.clone(ff_dropout=ff_dropout)
    size = configs["input_size"]
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, size["height"], size["width"], 3)), jnp.zeros((1, 4), jnp.int32),
        train=False))
    return jmodel, seeded_variables(dict(shapes), np.random.default_rng(seed))


@pytest.mark.parametrize("args", [(-1, 1), (-1, 2), (2, 2), (4, 1), (1, 4), (3, 2),
                                  (5, 1), (0, 1), (2, 0)])
def test_make_mesh_sizes_and_errors_match_jax(args):
    def outcome(make, devices):
        try:
            m = make(*args, devices)
        except ValueError as exc:
            return str(exc)
        return dict(m.shape)

    ranks = list(range(4))
    want = outcome(jax_mesh.make_mesh, jax.devices()[:4])
    got = outcome(mesh.make_mesh, ranks)
    assert got == want
    if isinstance(got, dict):
        m = mesh.make_mesh(*args, ranks)
        assert m.grid.ravel().tolist() == ranks[:m.size]


@pytest.mark.parametrize("network", sorted(FAMILIES))
def test_param_shardings_match_jax(network, vocab):
    jmodel, variables = jax_model(network, 0, vocab)
    tmodel = get_network(network, FAMILIES[network][1], vocab)
    routes = param_routes(network, tmodel.named_parameters())
    split = 0
    for n_model in (1, 2, 4):
        jmesh = jax_mesh.make_mesh(8 // n_model, n_model)
        jspecs = jax_mesh.param_shardings(variables["params"], jmesh)
        got = mesh.param_shardings(tmodel, network, mesh.Mesh(
            np.arange(8).reshape(8 // n_model, n_model)))
        assert set(got) == set(routes)
        for name, (path, _, _) in routes.items():
            leaf = jspecs
            for part in path.split("/"):
                leaf = leaf[part]
            ndim = tmodel.get_parameter(name).dim()
            want = tuple(leaf.spec) + (None,) * (ndim - len(leaf.spec))
            # a Linear's weight is the flax kernel transposed
            want = want[::-1] if any(want) else ()
            spec = got[name] + (None,) * (ndim - len(got[name])) if got[name] else ()
            assert spec == want, (network, n_model, name, path)
            split += bool(spec)
    # every family but EfficientASTER has projections that split
    assert (split > 0) == (network != "EfficientASTER")


def lite_case(vocab):
    """The gloo worlds' case (its mesh set per world) and the JAX side's
    models and variables. One global batch of 8 rows for both worlds."""
    jmodel, variables = jax_model("LiteSATRN", 0, vocab, ff_dropout=0.0)
    jmodel2, variables2 = jax_model("LiteSATRN", 1, vocab, ff_dropout=0.0)
    rng = np.random.default_rng(5)
    batch = 8
    size = LITE_CONFIGS["input_size"]
    images = rng.normal(size=(batch, size["height"], size["width"], 3)).astype(np.float32)
    text = np.full((batch, 8), vocab.pad_id, np.int64)
    text[:, 0] = vocab.sos_id
    for i in range(batch):  # 1 to 5 tokens: every shard its own pad count
        n = 1 + (3 * i) % 5
        text[i, 1:1 + n] = rng.integers(3, len(vocab), n)
        text[i, 1 + n] = vocab.eos_id
    sds = tuple({k: v.numpy() for k, v in state_dict_from_jax(
        "LiteSATRN", v["params"], v["batch_stats"]).items()} for v in (variables, variables2))
    case = Case("LiteSATRN", LITE_CONFIGS, sds, images, text, (1, 1),
                train_steps=STEPS, decode_steps=DECODE)
    return case, (jmodel, variables), (jmodel2, variables2)


def jax_side(case, first, second, vocab):
    """JAX's sharded train steps, then its sharded decodes, on the mesh."""
    n_data, n_model = case.mesh
    jmesh = jax_mesh.make_mesh(n_data, n_model, jax.devices()[:n_data * n_model])
    (jmodel, variables), (jmodel2, variables2) = first, second
    optimizer = jax_steps.build_optimizer(
        "adamw", jax_schedules.cosine_warmup_restarts(5e-4, 100), weight_decay=1e-6,
        max_grad_norm=2.0)
    params = jax.tree_util.tree_map(jnp.array, variables["params"])
    state = jax_steps.TrainState(params, variables["batch_stats"], optimizer.init(params),
                                 jnp.asarray(0, jnp.int32))
    step = jax_sharding.make_sharded_train_step(jmodel, optimizer, vocab.pad_id, jmesh)
    images, text = jax_mesh.shard_batch(jmesh, case.images, case.text.astype(np.int32))
    metrics = []
    for i in range(STEPS):
        state, m = step(state, images, text, jax.random.PRNGKey(i))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    trained = {"params": state.params, "batch_stats": state.batch_stats}
    # the DP paths take the weights whole (the JAX dry run's gather)
    whole = jax.device_put(trained, jax_mesh.replicated(jmesh))
    decode = jax_make_greedy_fn(jmodel, max_steps=DECODE, return_outputs=False)
    sharded_images = jax_mesh.shard_batch(jmesh, case.images)
    out = {"metrics": np.asarray(metrics), "state": jax.device_get(trained),
           "greedy": np.asarray(jax_sharding.make_sharded_infer_fn(decode, jmesh)(
               whole, sharded_images)),
           "tp": np.asarray(jax_sharding.make_tp_infer_fn(decode, jmesh, trained)(
               trained, sharded_images))}
    ensemble = make_ensemble_decode_fn([jmodel, jmodel2], max_steps=DECODE)
    members = [whole, variables2]
    memories = [jax.jit(lambda v, x, m=m: m.apply(v, x, method="encode"))(
        v, jnp.asarray(case.images)) for m, v in ((jmodel, whole), (jmodel2, variables2))]
    sharded = jax.jit(ensemble, in_shardings=(jax_mesh.replicated(jmesh),
                                              jax_mesh.batch_sharding(jmesh)),
                      out_shardings=jax_mesh.batch_sharding(jmesh))
    out["ensemble"] = np.asarray(sharded(members, [jax_mesh.shard_batch(jmesh, np.asarray(m))
                                                   for m in memories]))
    return out


WORLDS = ((1, 2), (2, 2))  # meshes: 2 ranks, 4 ranks


@pytest.fixture(scope="module")
def worlds(vocab):
    """``dryrun_multichip`` on both gloo worlds of one case (its own gates:
    the replay on a mesh of one rank, every rank's tokens against its decode
    without a mesh, the kernel path's refusal, a falling loss with the FF's
    pinned dropout), in threads that wait on the ranks while the JAX side
    compiles here -> (n_data, n_model) -> (its results, JAX's)."""
    case, first, second = lite_case(vocab)
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        runs = {shape: pool.submit(dryrun_multichip, shape[0] * shape[1], device="cpu",
                                   case=case._replace(mesh=shape)) for shape in WORLDS}
        jax_runs = {shape: jax_side(case._replace(mesh=shape), first, second, vocab)
                    for shape in WORLDS}
        return {shape: (runs[shape].result(), jax_runs[shape]) for shape in WORLDS}


@pytest.mark.parametrize("shape", WORLDS, ids=["1x2", "2x2"])
def test_gloo_world_matches_jax_and_the_one_rank_replay(shape, worlds):
    run, want = worlds[shape]
    ranks, replay = run["ranks"], run["replay"]
    world = shape[0] * shape[1]
    lrs = [schedules.cosine_warmup_restarts(5e-4, 100)(i) for i in range(STEPS)]
    got = ranks[0]
    assert got["mesh"][0] == {"data": shape[0], "model": shape[1]}
    for r in ranks:  # every rank holds the global loss and every row's tokens
        np.testing.assert_array_equal(r["losses"], got["losses"])
        for key in ("greedy_mesh", "ensemble_mesh", "tp_plain", "tp_module"):
            np.testing.assert_array_equal(r[key], got[key], err_msg=key)
        assert "tensor parallelism" in r["tp_kernel_refusal"]
    np.testing.assert_allclose(got["losses"], want["metrics"][:, 0], rtol=1e-5)
    # JAX's 2x2 mesh computes gradients ~4e-4 (relative, in their norm) off
    # its own single-device program, which its 1x2 mesh (and 4x1, 1x4)
    # reproduce: the grad norms and the weights are held against the 1x2
    # mesh's on the same batch, the losses and statistics against each mesh's
    ref = worlds[WORLDS[0]][1]
    np.testing.assert_allclose(got["grad_norms"], ref["metrics"][:, 1], rtol=1e-5)
    state = types.SimpleNamespace(state_dict=lambda: {
        k: torch.from_numpy(v) for k, v in got["state"].items()})
    assert_state_matches(state, ref["state"]["params"], want["state"]["batch_stats"],
                         2e-6 + 0.05 * lrs[-1], f"world {world}",
                         {k: torch.from_numpy(v) for k, v in got["quiet"].items()},
                         sum(lrs), network="LiteSATRN")
    np.testing.assert_allclose(got["losses"], replay["losses"], rtol=1e-5)
    np.testing.assert_allclose(got["grad_norms"], replay["grad_norms"], rtol=1e-5)
    np.testing.assert_array_equal(got["greedy_mesh"], want["greedy"])
    np.testing.assert_array_equal(got["greedy_mesh"], got["greedy"])
    np.testing.assert_array_equal(got["ensemble_mesh"], want["ensemble"])
    np.testing.assert_array_equal(got["tp_plain"], want["tp"])
    np.testing.assert_array_equal(got["tp_module"], want["tp"])


def test_nccl_refuses_more_ranks_than_cards(monkeypatch):
    """torchrun's ranks on one host each take a card under NCCL: more ranks
    than cards raise before any process group starts."""
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one card per rank: 2 ranks on this host, 1"):
        mesh.init_distributed("cuda")
    assert not torch.distributed.is_initialized()


def test_system_utils(tmp_path, capsys):
    with system.profile_trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "aten::mm" in json.dumps(json.load(f))
    system.print_device_status()
    system.print_ram_status()
    system.print_system_envs()
    out = capsys.readouterr().out
    assert "[+] Device Status" in out and "Usage:" in out
    assert f"The number of cpus : {os.cpu_count()}" in out
    assert len(system.get_timestamp()) == len("1018-101500")

