"""Multi-rank dry run of the port's mesh, the counterpart of the JAX
package's ``__graft_entry__.py::dryrun_multichip``.

``spawn`` (or ``start``, which returns while the ranks work) runs a
function on N ranks, each its own process in one gloo process group (host
tensors, or every rank on one card), and collects what each returns. ``run_case`` is what a rank runs: seeded weights for a
network, sharded train steps on a (data, model) mesh, then the
data-parallel greedy decode (the single path: kernels 1-3 on a card, their
plain versions on the host), the data-parallel ensemble, and the
tensor-parallel decodes (the plain fast step and the module step), each
against the same rank's decode without a mesh, and a kernel path under
tensor parallelism, which must raise. ``dryrun_multichip(n)`` holds n ranks
against a replay on a mesh of one rank in this process.

    python -m p4fr_tpu_torch.parallel.dryrun 4 [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import pickle
import queue
import socket
import tempfile
import time
import traceback
from typing import Callable, Dict, Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# LiteSATRN.yaml cut as the JAX dry run cuts it (64x128 input, one encoder
# and one decoder layer), dropout at the config's rate
LITE_TINY = {
    "network": "LiteSATRN",
    "input_size": {"height": 64, "width": 128},
    "SATRN": {
        "encoder": {"hidden_dim": 256, "filter_dim": 256, "layer_num": 1, "head_num": 4},
        "decoder": {"src_dim": 256, "hidden_dim": 128, "filter_dim": 512,
                    "layer_num": 1, "head_num": 4},
    },
    "data": {"rgb": 3},
    "dropout_rate": 0.1,
    "tpu": {"compute_dtype": "float32", "reference_parity": True},
}
RANK_TIMEOUT_S = 600
POLL_S = 2.0  # how often a wait looks for ranks that died without a result


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, job: str, out) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                rank=rank, world_size=world)
        try:
            # pickled here, by value: a tensor put on the queue as it is goes
            # by shared memory, which this process would take down on exit
            out.put((rank, pickle.dumps(fn(rank, world, *args)), None))
        finally:
            dist.destroy_process_group()
    except BaseException:  # reported to the parent, which raises
        out.put((rank, None, traceback.format_exc()))


def start(world: int, fn: Callable, *args, timeout: float = RANK_TIMEOUT_S
          ) -> Callable[[], List]:
    """Start ``fn(rank, world, *args)`` on ``world`` spawned processes joined
    in one gloo process group -> ``wait()``, which returns each rank's
    return value, in rank order. ``wait`` raises with a rank's traceback if
    one fails (the other ranks are killed), as soon as one has exited
    without a result, or if one has not returned within ``timeout``
    seconds; no process outlives it, and a second call
    gives the first's results or error. The caller works on meanwhile."""
    ctx = torch.multiprocessing.get_context("spawn")
    out = ctx.Queue()
    port = _free_port()
    # the job goes by file: a large argument would hold each start() until
    # its child had read it
    fd, job = tempfile.mkstemp(suffix=".pkl")
    with os.fdopen(fd, "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main, args=(rank, world, port, job, out))
             for rank in range(world)]
    for p in procs:
        p.start()

    outcome: Dict[str, object] = {}

    def wait() -> List:
        if outcome:  # waited for before: the same results, or the same error
            if "error" in outcome:
                raise outcome["error"]
            return outcome["results"]
        results: Dict[int, object] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(results) < world:
                try:
                    rank, value, error = out.get(timeout=POLL_S)
                except queue.Empty:
                    # a rank that died without a word (a crash, or a failed
                    # start) is reported now, not at the deadline; its result
                    # would have reached the queue before it exited
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode not in (None, 0)]
                    if dead and out.empty():
                        raise RuntimeError(
                            f"spawn: rank(s) {dead} of {world} exited with code(s) "
                            f"{[procs[r].exitcode for r in dead]} and no result") from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"spawn: {world - len(results)} rank(s) gave "
                                           f"no result within {timeout} s") from None
                    continue
                if error is not None:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{error}")
                results[rank] = pickle.loads(value)
        except BaseException as exc:
            outcome["error"] = exc
            raise
        finally:
            for p in procs:
                p.join(timeout=0 if "error" in outcome else 30)
                if p.is_alive():
                    p.kill()
                    p.join()
            os.unlink(job)
        outcome["results"] = [results[r] for r in range(world)]
        return outcome["results"]

    return wait


def spawn(world: int, fn: Callable, *args, timeout: float = RANK_TIMEOUT_S) -> List:
    """``start`` and wait: each rank's return value, in rank order."""
    return start(world, fn, *args, timeout=timeout)()


class Case(NamedTuple):
    """What ``run_case`` runs. ``state_dicts``: the weights of the model
    (first) and of the ensemble's other members, numpy; ``images`` [B, H, W,
    C] standardized f32 and ``text`` [B, L] the global batch; ``mesh`` (n_data,
    n_model). The train steps run with every dropout site at 0 (the equality
    runs: one rank's generator cannot draw another's masks); with
    ``dropout_run`` they run once more, from the same weights, with every
    site at its configured rate."""
    network: str
    configs: dict
    state_dicts: Tuple[Dict[str, np.ndarray], ...]
    images: np.ndarray
    text: np.ndarray
    mesh: Tuple[int, int]
    train_steps: int = 4
    decode_steps: int = 8
    dropout_run: bool = True
    device: str = "cpu"


def seeded_state_dict(network: str, configs: dict, seed: int) -> Dict[str, np.ndarray]:
    """A model's weights drawn from ``seed`` (its initializers), numpy."""
    from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
    from p4fr_tpu_torch.models.registry import get_network

    torch.manual_seed(seed)
    model = get_network(network, configs, Vocab.from_files([TOKENS_PATH]))
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _model(case: Case, index: int, dev, dropout: bool = False):
    from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab
    from p4fr_tpu_torch.models.registry import get_network

    vocab = Vocab.from_files([TOKENS_PATH])
    model = get_network(case.network, case.configs, vocab, device=dev)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in case.state_dicts[index].items()},
                          strict=True)
    if not dropout:
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    return model, vocab


def _train(case: Case, dev, mesh, dropout: bool = False):
    """The case's train steps on ``mesh`` -> (model, losses, grad norms,
    quiet elements)."""
    from p4fr_tpu_torch.parallel.sharding import make_sharded_train_step
    from p4fr_tpu_torch.train.schedules import cosine_warmup_restarts
    from p4fr_tpu_torch.train.steps import build_optimizer

    model, vocab = _model(case, 0, dev, dropout)
    optimizer = build_optimizer("adamw", model.parameters(),
                                cosine_warmup_restarts(5e-4, 100), weight_decay=1e-6,
                                max_grad_norm=2.0)
    step = make_sharded_train_step(model, optimizer, vocab.pad_id, mesh, case.network)
    images = torch.from_numpy(case.images).to(dev)
    text = torch.from_numpy(case.text).long().to(dev)
    losses, norms = [], []
    quiet = {name: np.zeros(tuple(p.shape), bool) for name, p in model.named_parameters()}
    for _ in range(case.train_steps):
        metrics = step(images, text)
        losses.append(metrics["loss"].item())
        norms.append(metrics["grad_norm"].item())
        top = max(p.grad.abs().max().item() for p in model.parameters())
        for name, p in model.named_parameters():
            quiet[name] |= (p.grad.abs() < 1e-5 * top).cpu().numpy()
    return model.eval(), np.asarray(losses), np.asarray(norms), quiet


@contextlib.contextmanager
def _exact_f32(dev: torch.device) -> Iterator[None]:
    """On a card: f32 without TF32 and cuDNN's deterministic algorithms for
    the block (the equality runs' numerics), the flags restored after."""
    if dev.type != "cuda":
        yield
        return
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = flags


def run_case(rank: int, world: int, case: Case) -> Dict[str, object]:
    """One rank's run of ``case`` (``world`` 1 without a process group: the
    mesh of one rank; on a card in f32 without TF32, cuDNN deterministic)
    -> {"losses", "grad_norms", "state" (the trained state dict, rank 0
    only), "quiet" (each parameter's elements whose reduced gradient fell
    below 1e-5 of the step's largest at some step: Adam moves them by a sign
    that rounding picks, so a comparison holds them apart), "greedy",
    "greedy_mesh", "ensemble", "ensemble_mesh", "tp_plain", "tp_module"
    (tokens of every row), "tp_kernel_refusal" (the error text), "mesh",
    "dropout_losses" (with ``case.dropout_run``)}, numpy."""
    dev = torch.device(case.device)
    if dev.index is not None:
        torch.cuda.set_device(dev)
    with _exact_f32(dev):
        return _run_case(rank, case, dev)


def _run_case(rank: int, case: Case, dev: torch.device) -> Dict[str, object]:
    from p4fr_tpu_torch.decoding.greedy import make_greedy_fn
    from p4fr_tpu_torch.infer.ensemble import ensemble_decode
    from p4fr_tpu_torch.infer.single import build_fast, decode_images, encode_images
    from p4fr_tpu_torch.parallel.mesh import make_mesh
    from p4fr_tpu_torch.parallel.sharding import make_sharded_infer_fn, make_tp_infer_fn

    mesh = make_mesh(*case.mesh)
    model, losses, norms, quiet = _train(case, dev, mesh)
    out: Dict[str, object] = {
        "losses": losses, "grad_norms": norms, "quiet": quiet,
        "mesh": (mesh.shape, mesh.coords),
        "state": ({k: v.cpu().numpy() for k, v in model.state_dict().items()}
                  if rank == 0 else None)}
    if case.dropout_run:
        out["dropout_losses"] = _train(case, dev, mesh, dropout=True)[1]
    steps = case.decode_steps
    images = torch.from_numpy(case.images).to(dev)
    with torch.no_grad():
        fast = build_fast(model)

        def greedy(im):
            return decode_images(model, fast, im, None, steps)

        out["greedy"] = greedy(images).cpu().numpy()
        out["greedy_mesh"] = make_sharded_infer_fn(greedy, mesh)(images).numpy()

        members = [(model, fast)] + [
            (m, build_fast(m)) for m in (_model(case, i, dev)[0]
                                         for i in range(1, len(case.state_dicts)))]

        def joint(im):
            memories = [encode_images(m, im) for m, _ in members]
            return ensemble_decode(members, memories, max_steps=steps)

        if len(members) > 1:
            out["ensemble"] = joint(images).cpu().numpy()
            out["ensemble_mesh"] = make_sharded_infer_fn(joint, mesh)(images).numpy()

        def plain(f, im):
            return decode_images(model, f, im, None, steps, kernel="jnp")

        module = make_greedy_fn(model, max_steps=steps, return_outputs=False)
        out["tp_plain"] = make_tp_infer_fn(plain, mesh, model, case.network)(images).numpy()
        out["tp_module"] = make_tp_infer_fn(lambda f, im: module(im), mesh, model,
                                            case.network)(images).numpy()
        try:
            make_tp_infer_fn(lambda f, im: decode_images(model, f, im, None, steps),
                             mesh, model, case.network)(images)
        except ValueError as exc:
            out["tp_kernel_refusal"] = str(exc)
    return out


def lite_case(n_ranks: int, *, seed: int = 0) -> Case:
    """The dry run's case: the LiteSATRN cut to ``LITE_TINY`` with seeded
    weights (and a second seeded member for the ensemble), 2 rows a rank of
    seeded images, and labels of 1 to 5 tokens so that the shards hold
    different pad counts; ``n_model`` 2 where ``n_ranks`` is even."""
    from p4fr_tpu_torch.data.vocab import TOKENS_PATH, Vocab

    vocab = Vocab.from_files([TOKENS_PATH])
    n_model = 2 if n_ranks % 2 == 0 and n_ranks > 1 else 1
    rng = np.random.default_rng(seed)
    batch, label_len = 2 * n_ranks, 8
    size = LITE_TINY["input_size"]
    images = rng.normal(size=(batch, size["height"], size["width"], 3)).astype(np.float32)
    text = np.full((batch, label_len), vocab.pad_id, np.int64)
    text[:, 0] = vocab.sos_id
    for i in range(batch):
        n = 1 + i % 5
        text[i, 1:1 + n] = rng.integers(3, len(vocab), n)
        text[i, 1 + n] = vocab.eos_id
    return Case("LiteSATRN", LITE_TINY,
                tuple(seeded_state_dict("LiteSATRN", LITE_TINY, seed + k) for k in (0, 1)),
                images, text, (n_ranks // n_model, n_model))


def dryrun_multichip(n_ranks: int, device: str = "cuda",
                     case: Optional[Case] = None) -> Dict[str, object]:
    """n gloo ranks (on ``device``: every rank on the one card, or with
    ``device="cpu"`` the host; raises if CUDA is asked for and absent)
    against a mesh of one rank in this process, on ``case`` (default
    ``lite_case(n)``; its mesh must hold n ranks; it runs on ``device``):

    - its train steps with dropout off: the losses against the replay's at
      rtol 1e-5 (as the JAX dry run holds them), and the loss falls;
    - the data-parallel greedy and ensemble tokens, and the tensor-parallel
      tokens of the plain fast step and of the module step, equal to each
      rank's decode without a mesh, and the kernel path under tensor
      parallelism refused;
    - the same steps with the case's dropout sites at their rates, in the
      same spawned world: finite, falling losses.
    -> the ranks' and the replay's results."""
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device {device!r}")
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip: CUDA was asked for and no CUDA card is "
                           "visible; pass device='cpu' to run on the CPU")
    case = (case or lite_case(n_ranks))._replace(device=device, dropout_run=True)
    if case.mesh[0] * case.mesh[1] != n_ranks:
        raise ValueError(f"a {case.mesh} mesh does not hold {n_ranks} ranks")
    wait = start(n_ranks, run_case, case)
    try:
        replay = run_case(0, 1, case._replace(mesh=(1, 1), dropout_run=False))
    finally:
        ranks = wait()
    losses = ranks[0]["losses"]
    np.testing.assert_allclose(losses, replay["losses"], rtol=1e-5, atol=1e-6,
                               err_msg="sharded loss trajectory diverged from the replay")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall over {len(losses)} steps: {losses}")
    for r in ranks:
        np.testing.assert_array_equal(r["losses"], losses)
        for key in ("greedy_mesh", "ensemble_mesh", "tp_plain", "tp_module"):
            want = r["ensemble" if key == "ensemble_mesh" else "greedy"]
            np.testing.assert_array_equal(r[key], want, err_msg=f"{key} rank {r['mesh']}")
        if "tensor parallelism" not in r.get("tp_kernel_refusal", ""):
            raise AssertionError("a kernel path ran under tensor parallelism")
    noisy = ranks[0]["dropout_losses"]
    if not (np.isfinite(noisy).all() and noisy[-1] < noisy[0]):
        raise AssertionError(f"with dropout the loss did not fall: {noisy}")
    print(f"[dryrun_multichip] mesh={ranks[0]['mesh'][0]} batch={len(case.images)} "
          f"losses={['%.4f' % v for v in losses]} (== 1-rank replay), with dropout "
          f"{['%.4f' % v for v in noisy]}; DP greedy, DP ensemble, TP plain and TP "
          f"module tokens equal ok; kernel path under TP refused")
    return {"ranks": ranks, "replay": replay, "dropout_losses": noisy}


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_ranks", type=int)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="every rank on the one card (default), or the host's "
                             "gloo ranks")
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA card is visible; pass --device cpu to run on the CPU")
    dryrun_multichip(args.n_ranks, args.device)


if __name__ == "__main__":
    main()
