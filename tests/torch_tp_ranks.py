"""Rank workers of tests/test_torch_tp_serve.py, tests/test_torch_ep_moe.py,
tests/test_torch_tp_families.py, tests/test_torch_small_serve.py,
tests/test_torch_sharded_train.py,
tests/test_torch_sharded_train_families.py and tests/test_torch_pipeline.py. Spawned ranks import this module, not
the test modules, so they start without JAX: they run the port only, and
the tests compare their results with the JAX package."""
import dataclasses
import os

import torch

from repro_torch.configs import reduced
from repro_torch.core import steps
from repro_torch.launch import mesh as tmesh
from repro_torch.models.params import from_reference, leaves

ROWS, PROMPT, STEPS = 4, 16, 8
# name: (arch, fields replaced in its reduced config). The yi-like ratio (6
# q heads, 2 KV heads) gets zero q slots at tp 4; h2o-danube's 16-slot
# window ring wraps during the decode steps; phi-3-vision's first 8 prompt
# positions take img_embeds.
CONFIGS = {"tinyllama": ("tinyllama-1.1b", {}),
           "yi-like": ("tinyllama-1.1b", dict(n_heads=6, n_kv_heads=2, head_dim=16)),
           "h2o-danube": ("h2o-danube-1.8b", {}),
           "phi-3-vision": ("phi-3-vision-4.2b", {})}
# The MoE, SSM and hybrid families (tests/test_torch_tp_families.py), with
# capacity to spare so that no token drops and sharded equals unsharded;
# mixtral-wg has 3 experts, which a data axis of 2 does not divide (the
# weight-gather mode).
NO_DROP = 8.0
FAMILY_CONFIGS = {"mixtral": ("mixtral-8x22b", dict(capacity_factor=NO_DROP)),
                  "mixtral-wg": ("mixtral-8x22b", dict(capacity_factor=NO_DROP, n_experts=3)),
                  "moonshot": ("moonshot-v1-16b-a3b", dict(capacity_factor=NO_DROP)),
                  "mamba2": ("mamba2-370m", {}),
                  "jamba": ("jamba-v0.1-52b", dict(capacity_factor=NO_DROP))}


# The small-serve layout (tests/test_torch_small_serve.py): name: (arch,
# fields, prompt length, cache_len). Prompts of 4 in a ring of 32 leave the
# cuts of ranks above 0 without a valid key for the first decode steps (at
# tp 4 rank 1 fills from step 4, rank 2 from step 12, rank 3 never); a ring
# of 33 no axis divides stays whole; h2o-danube's 16-slot window ring is
# shorter than its 20-token prompt, so prefill wraps it and decode wraps it
# again; reduced mixtral's window of 16 holds its 16-token prompt (its
# token groups are 64 rows x positions); whisper's 24-frame cross cache is
# cut too.
SMALL_STEPS = 14
SMALL_CONFIGS = {"tinyllama": ("tinyllama-1.1b", {}, 4, 32),
                 "tinyllama-whole": ("tinyllama-1.1b", {}, 4, 33),
                 "h2o-danube": ("h2o-danube-1.8b", {}, 20, 36),
                 "mixtral": ("mixtral-8x22b", dict(capacity_factor=NO_DROP), 16, 32),
                 "whisper": ("whisper-base", {}, 4, 32)}


def config(name):
    """The reduced config of CONFIGS[name] (or FAMILY_CONFIGS[name], or
    SMALL_CONFIGS[name]) at fp32."""
    arch, fields = (CONFIGS.get(name) or FAMILY_CONFIGS.get(name)
                    or SMALL_CONFIGS[name][:2])
    return dataclasses.replace(reduced(arch), dtype="float32", **fields)


def port_run(params, prompts, forced, prefill, decode, img_embeds=None):
    """Prefill (with img_embeds where given), then STEPS decode steps fed
    forced[:, i]: the logits [1 + STEPS, B, V] (numpy) and the cache."""
    inputs = {"tokens": prompts, "cache_len": PROMPT + STEPS}
    if img_embeds is not None:
        inputs["img_embeds"] = img_embeds
    logits, cache = prefill(params, inputs)
    out = [logits[:, 0]]
    for i in range(STEPS):
        logits, cache = decode(params, {"cache": cache, "tokens": forced[:, i:i + 1],
                                        "pos": PROMPT + i})
        out.append(logits[:, 0])
    return torch.stack(out).numpy(), cache


def serve_rank(rank, world, backend, shape, refs):
    """One rank: every config of `refs` ({name: (the JAX package's weights
    as numpy, prompts, img_embeds or None, greedy tokens)}) through the
    sharded steps on its shards, which `shard_params` cuts from the whole
    tree and, leaf by leaf, from a stream of its leaves (the two must agree
    bit for bit). On (2, 2) also: DTensor's cut of a dim over ('pod',
    'data') against sharding.local_shard, and make_slice_mesh over the
    world."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.distributed import sharding as shd

    torch.set_num_threads(1)
    shd._small_serve = lambda cfg: False   # the head layout of full-width models
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    out = {"backend": backend, "coord": list(mesh.get_coordinate())}
    for name, (jp, prompts, img, toks) in refs.items():
        cfg = config(name)
        full = from_reference(jp, cfg, "cpu")
        local = steps.shard_params(full, cfg, mesh)
        streamed = steps.shard_params(iter(list(leaves(full))), cfg, mesh)
        del full
        logits, cache = port_run(
            local, steps.shard_batch(torch.from_numpy(prompts), mesh),
            steps.shard_batch(torch.from_numpy(toks), mesh),
            steps.sharded_prefill(cfg, mesh, batch=ROWS),
            steps.sharded_decode(cfg, mesh, batch=ROWS),
            None if img is None else steps.shard_batch(torch.from_numpy(img), mesh))
        out[name] = dict(logits=logits,
                         params={k: tuple(v.shape) for k, v in leaves(local)},
                         cache={k: tuple(v.shape) for k, v in leaves(cache)},
                         streamed_equal=all(torch.equal(v, w) for (_, v), (_, w)
                                            in zip(leaves(local), leaves(streamed))))
    if shape == (2, 2):
        cube = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))
        full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
        pl = (Shard(0), Shard(0), Replicate())
        dt = distribute_tensor(full, cube, list(pl))
        out["dtensor_order"] = torch.equal(
            dt.to_local(), shd.local_shard(full, pl, cube, cube.get_coordinate()))
        sl = tmesh.make_slice_mesh(range(world), device="cpu")
        out["slice_mesh"] = (tuple(sl.mesh_dim_names), tuple(sl.shape))
    return out


def small_run(params, prompts, forced, prefill, decode, prompt, cache_len, frames=None):
    """Prefill (with audio frames where given) into `cache_len` slots, then
    SMALL_STEPS decode steps fed forced[:, i]: (the logits [1 + steps, B,
    V], the cache after prefill and after the last step, {path: numpy})."""
    inputs = {"tokens": prompts, "cache_len": cache_len}
    if frames is not None:
        inputs["audio_frames"] = frames
    logits, cache = prefill(params, inputs)
    first = {k: v.numpy().copy() for k, v in leaves(cache)}
    out = [logits[:, 0]]
    for i in range(SMALL_STEPS):
        logits, cache = decode(params, {"cache": cache, "tokens": forced[:, i:i + 1],
                                        "pos": prompt + i})
        out.append(logits[:, 0])
    return torch.stack(out).numpy(), first, {k: v.numpy() for k, v in leaves(cache)}


def small_rank(rank, world, backend, shape, refs):
    """One rank of the small-serve layout: every config of `refs` ({name:
    (the JAX package's weights as numpy, prompts, audio frames or None,
    greedy tokens)}) through the sharded steps on the rank's shards, the
    reduced configs' own small-serve rule on. Counts the decode-attention
    calls that return the log-sum-exp and those whose rows all have no
    valid key in the rank's cut."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.kernels import ops

    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    out = {"coord": list(mesh.get_coordinate())}
    calls = {"lse": 0, "plain": 0, "empty": 0}
    attend = ops.decode_attention

    def counted(q, k, v, valid_len, return_lse=False):
        calls["lse" if return_lse else "plain"] += 1
        calls["empty"] += int(return_lse and int(valid_len.max()) == 0)
        return attend(q, k, v, valid_len, return_lse=return_lse)

    ops.decode_attention = counted
    for name, (jp, prompts, frames, toks) in refs.items():
        _, _, prompt, cache_len = SMALL_CONFIGS[name]
        cfg = config(name)
        local = steps.shard_params(from_reference(jp, cfg, "cpu"), cfg, mesh)
        cut = lambda a: None if a is None else steps.shard_batch(torch.from_numpy(a), mesh)
        calls.update(lse=0, plain=0, empty=0)
        logits, first, last = small_run(
            local, cut(prompts), cut(toks), steps.sharded_prefill(cfg, mesh, batch=ROWS),
            steps.sharded_decode(cfg, mesh, batch=ROWS, cache_len=cache_len), prompt,
            cache_len, cut(frames))
        out[name] = dict(logits=logits, first=first, last=last, calls=dict(calls),
                         params={k: tuple(v.shape) for k, v in leaves(local)})
    return out


def die_rank(rank, world, backend):
    """Rank 1 dies; rank 0 waits on it in a collective."""
    if rank == 1:
        os._exit(3)
    torch.distributed.barrier()
    return rank


def _moe_leaf_axes():
    from repro_torch.models.params import _moe_defs

    return {k: v.axes for k, v in _moe_defs(config("mixtral")).items() if k != "shared"}


def moe_layer_rank(rank, world, backend, shape, cases):
    """One rank of tests/test_torch_ep_moe.py: each case (name: (config
    fields, x [B, S, D], the layer's weights {router, wi_gate, wi_up, wo},
    all numpy)) through `layers.moe` on the rank's rows (`shard_batch`)
    and its shards of the weights (the serve rules' placements), under the
    mesh. Returns {name: (y of the rank's rows, aux, whether moe_shard_map
    ran)} and the rank's coordinate."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import ctx as dctx
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as L

    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    coord = list(mesh.get_coordinate())
    axes = _moe_leaf_axes()
    out = {"coord": coord}
    ran = []
    shard_map = L.moe_shard_map

    def counted(*a, **k):
        ran.append(1)
        return shard_map(*a, **k)

    L.moe_shard_map = counted
    for name, (fields, x, w) in cases.items():
        cfg = dataclasses.replace(config("mixtral"), **fields)
        rules = shd.serve_rules(mesh, cfg)
        p = {k: shd.local_shard(torch.from_numpy(v), shd.spec_for(v.shape, axes[k], rules, mesh),
                                mesh, coord).contiguous() for k, v in w.items()}
        xt = torch.from_numpy(x)
        xl = steps.shard_batch(xt, mesh)
        ran.clear()
        with dctx.mesh_context(mesh, rows_cut=steps._rows_cut(mesh, xt.shape[0], xl.shape[0])):
            y, aux = L.moe(xl, p, cfg)
        out[name] = (y.numpy(), float(aux), bool(ran),
                     {k: tuple(v.shape) for k, v in p.items()})
    return out


def ssm_block_rank(rank, world, backend, shape, cfg_fields, params, x, x1s):
    """One rank of the sharded Mamba2 block: `ssm_block` over x [B, L, D]
    with its final state, then one `ssm_block_decode` step a row of x1s
    [n, B, 1, D] from there, on the rank's shards of one layer's weights
    (numpy, cut by the serve rules). Returns the outputs (the same on every
    rank) and the rank's conv and state caches."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import ctx as dctx
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import layers as L
    from repro_torch.models.params import _ssm_defs

    torch.set_num_threads(1)
    cfg = dataclasses.replace(config("mamba2"), **cfg_fields)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    coord = list(mesh.get_coordinate())
    rules = shd.serve_rules(mesh, cfg)
    defs = _ssm_defs(cfg)
    p = {k: shd.local_shard(torch.from_numpy(v), shd.spec_for(v.shape, defs[k].axes, rules,
                                                               mesh), mesh, coord).contiguous()
         for k, v in params.items()}
    with dctx.mesh_context(mesh):
        y, (conv, state) = L.ssm_block(torch.from_numpy(x), p, cfg, return_state=True)
        outs, convs, states = [], [conv], [state]
        for x1 in x1s:
            o, (conv, state) = L.ssm_block_decode(torch.from_numpy(x1), p, cfg, conv, state)
            outs.append(o.numpy())
            convs.append(conv)
            states.append(state)
    return dict(coord=coord, y=y.numpy(), decode=outs,
                conv=[c.numpy() for c in convs], state=[s.numpy() for s in states])


# The sharded train step (tests/test_torch_sharded_train.py): name: (arch,
# mesh, batch rows, sequence, microbatches, attention batch-DP by the rule
# (True) or forced off (False)).
TRAIN_SEQ = 32
TRAIN_CASES = {
    "tinyllama-2x2": ("tinyllama-1.1b", (2, 2), 4, TRAIN_SEQ, 1, True),
    "tinyllama-2x2-dp-off": ("tinyllama-1.1b", (2, 2), 4, TRAIN_SEQ, 1, False),
    "h2o-danube-2x2": ("h2o-danube-1.8b", (2, 2), 4, TRAIN_SEQ, 1, True),
    "phi-3-vision-2x2": ("phi-3-vision-4.2b", (2, 2), 4, TRAIN_SEQ, 1, True),
    "tinyllama-1x4": ("tinyllama-1.1b", (1, 4), 2, TRAIN_SEQ, 1, True),
    "tinyllama-1x4-dp-off": ("tinyllama-1.1b", (1, 4), 2, TRAIN_SEQ, 1, False),
    "tinyllama-1x4-mb4": ("tinyllama-1.1b", (1, 4), 4, TRAIN_SEQ, 4, True),
    "tinyllama-4x1": ("tinyllama-1.1b", (4, 1), 4, TRAIN_SEQ, 1, True),
}
# lr 1e-4: AdamW moves a weight whose gradient is near 0 by about lr, so
# the ulps of the first step's gradients move the second step's; at 1e-3
# h2o-danube's moments after two steps (one device or sharded, with
# gradients within 1e-6 of the reference's) drift to 2.7e-4 of their
# magnitude from the reference's, past the 1e-4 the tests hold them to
TRAIN_OPT = dict(lr=1e-4, warmup_steps=1, total_steps=4)


def train_config(arch):
    return dataclasses.replace(reduced(arch), dtype="float32")


def train_batches(cfg, b, s, n=2, seed=0):
    """n batches of b x s tokens and labels (some -100, differently on each
    row), and img_embeds for a vlm: numpy draws of `seed`."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        bt = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32),
              "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
        bt["labels"][0, :3] = -100
        bt["labels"][-1, -5:] = -100
        if cfg.n_img_tokens:
            bt["img_embeds"] = rng.standard_normal(
                (b, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
        if cfg.enc_layers:
            bt["audio_frames"] = rng.standard_normal(
                (b, cfg.n_audio_ctx, cfg.d_model)).astype(np.float32)
        out.append(bt)
    return out


def train_rank(rank, world, backend, shape, cases, loop_dir, compress):
    """One rank of a mesh of tests/test_torch_sharded_train.py. cases:
    {name: (the JAX package's weights as numpy, the batches)}, each through
    two sharded train steps from the weights cut by `shard_train_state`;
    returns each step's metrics, the rank's shard shapes, the calls of the
    batch-DP re-layout and of the head_dim split, and on rank 0 the whole
    state after (`unshard_train_state`). loop_dir (or None): train() on the
    mesh uninterrupted (4 steps, a checkpoint every 2) and, in a second
    directory, failing at step 3 and restarted. compress (or None): {"g",
    "e"}, lists of this mesh's ranks' gradient and error trees, through
    `allreduce_compressed` over the data axis."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import ctx as dctx
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.training import train_loop
    from repro_torch.training.grad_compression import allreduce_compressed
    from repro_torch.training.optimizer import OptConfig, init_opt_state

    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    out = {"coord": list(mesh.get_coordinate())}
    calls = {"rows_to_model": 0, "split_model": 0}
    for fn in calls:
        def counted(*a, _f=getattr(dctx, fn), _n=fn, **k):
            calls[_n] += 1
            return _f(*a, **k)
        setattr(dctx, fn, counted)
    train_cfg = steps._train_cfg
    for name, (jp, batches) in cases.items():
        arch, _, _, _, mb, dp = TRAIN_CASES[name]
        cfg = train_config(arch)
        params = from_reference(jp, cfg, "cpu")
        local = steps.shard_train_state({"params": params, "opt": init_opt_state(params)},
                                        cfg, mesh)
        step = steps.make_sharded_train_step(cfg, mesh, OptConfig(**TRAIN_OPT), mb)
        steps._train_cfg = train_cfg if dp else (lambda c, m, b: c)
        calls.update(rows_to_model=0, split_model=0)
        metrics = []
        try:
            for b in batches:
                local, m = step(local, steps.shard_train_batch(b, mesh, mb))
                metrics.append({k: float(v) for k, v in m.items()})
        finally:
            steps._train_cfg = train_cfg
        whole = steps.unshard_train_state(local, cfg, mesh)
        out[name] = dict(metrics=metrics, calls=dict(calls),
                         shapes={k: tuple(v.shape) for k, v in leaves(local["params"])},
                         state=({k: v.numpy() for k, v in leaves(whole)} if rank == 0
                                else None))
    if loop_dir is not None:
        cfg = train_config("tinyllama-1.1b")
        dc = DataConfig(global_batch=4, seq_len=16)

        def run(sub, **kw):
            tc = train_loop.TrainLoopConfig(total_steps=4, ckpt_dir=os.path.join(loop_dir, sub),
                                            ckpt_every=2, log_every=100)
            return train_loop.train(cfg, dc, tc, device="cpu", mesh=mesh, **kw)

        whole = run("whole")
        try:
            run("restart", fail_at_step=3)
            failed = None
        except RuntimeError as e:
            failed = str(e)
        again = run("restart")
        final = steps.unshard_train_state(whole["final_state"], cfg, mesh)
        out["loop"] = dict(losses=whole["losses"], failed=failed, restarted=again["losses"],
                           final=({k: v.numpy() for k, v in leaves(final)} if rank == 0
                                  else None))
    if compress is not None:
        me = out["coord"][0]
        g = {k: torch.from_numpy(v) for k, v in compress["g"][me].items()}
        e = {k: torch.from_numpy(v) for k, v in compress["e"][me].items()}
        with dctx.mesh_context(mesh):
            avg, err = allreduce_compressed(g, e)
        out["compress"] = ({k: v.numpy() for k, v in avg.items()},
                           {k: v.numpy() for k, v in err.items()})
    return out


# The sharded train step of the MoE, SSM, hybrid and encoder-decoder
# families (tests/test_torch_sharded_train_families.py): name: (arch, mesh,
# batch rows, sequence, microbatches, fields replaced in its reduced
# config), at the configs' capacity. moonshot's 4 experts cut over 2 data
# ranks (expert parallel); mixtral with 3 experts, which 2 data ranks do
# not divide (weight-gather: the experts' d_model cut over `data`); jamba
# in 2 microbatches (its TRAIN_MICROBATCHES, 16, does not divide 4 rows);
# moonshot with the sort dispatch takes the MoE's global groups. A mesh of
# three axes is (pod, data, model): on (2, 2, 1) the experts go over `data`
# alone (EP; their gradients summed over `pod`) or their d_model over `pod`
# and `data` (weight-gather), and the MoE groups over both.
FAMILY_TRAIN_CASES = {
    "moonshot-ep-2x2": ("moonshot-v1-16b-a3b", (2, 2), 4, TRAIN_SEQ, 1, {}),
    "mixtral-wg-2x2": ("mixtral-8x22b", (2, 2), 4, TRAIN_SEQ, 1, dict(n_experts=3)),
    "mamba2-1x4": ("mamba2-370m", (1, 4), 4, TRAIN_SEQ, 1, {}),
    "mamba2-2x2": ("mamba2-370m", (2, 2), 4, TRAIN_SEQ, 1, {}),
    "jamba-2x2": ("jamba-v0.1-52b", (2, 2), 4, TRAIN_SEQ, 2, {}),
    "whisper-2x2": ("whisper-base", (2, 2), 4, TRAIN_SEQ, 1, {}),
    "moonshot-sort-2x2": ("moonshot-v1-16b-a3b", (2, 2), 4, TRAIN_SEQ, 1,
                          dict(moe_impl="sort")),
    "moonshot-ep-2x2x1": ("moonshot-v1-16b-a3b", (2, 2, 1), 4, TRAIN_SEQ, 1, {}),
    "mixtral-wg-2x2x1": ("mixtral-8x22b", (2, 2, 1), 4, TRAIN_SEQ, 1, dict(n_experts=3)),
}
# train() on a mesh for one MoE arch: reduced moonshot, 4 steps of 4 x 16
# tokens. Groups of 32 tokens are the same groups on one device and on 2
# data ranks; the router loss weighs 0, since a mesh's is the mean of the
# data ranks' losses over their own tokens (in both packages)
FAMILY_LOOP_ARCH = "moonshot-v1-16b-a3b"
FAMILY_LOOP_FIELDS = dict(moe_group_size=32, router_aux_weight=0.0)


def family_train_config(name):
    arch, _, _, _, _, fields = FAMILY_TRAIN_CASES[name]
    return dataclasses.replace(train_config(arch), **fields)


def family_loop_config():
    return dataclasses.replace(train_config(FAMILY_LOOP_ARCH), **FAMILY_LOOP_FIELDS)


def family_train_rank(rank, world, backend, shape, cases, loop_dir):
    """One rank of a mesh of tests/test_torch_sharded_train_families.py.
    cases: {name: (the JAX package's weights as numpy, the batches)}, each
    through two sharded train steps from the weights cut by
    `shard_train_state`; returns each step's metrics, the rank's shard
    shapes, the calls of `layers.moe_shard_map` and of the data-axis sum's
    backward of the global groups, and on rank 0 the whole state after
    (`unshard_train_state`). loop_dir (or None): train() of reduced
    moonshot on the mesh, 4 steps with a checkpoint every 2, and again in
    a second directory failing at step 3 and restarted."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.data.pipeline import DataConfig
    from repro_torch.models import layers as L
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import OptConfig, init_opt_state

    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", shape,
                            mesh_dim_names=("pod", "data", "model")[-len(shape):])
    out = {"coord": list(mesh.get_coordinate())}
    calls = {"moe_shard_map": 0, "own_rows": 0}
    shard_map, close = L.moe_shard_map, L._close_experts

    def counted_shard_map(*a, **k):
        calls["moe_shard_map"] += 1
        return shard_map(*a, **k)

    def counted_close(y, p, n, own_rows=False):
        calls["own_rows"] += bool(own_rows)
        return close(y, p, n, own_rows)

    L.moe_shard_map, L._close_experts = counted_shard_map, counted_close
    for name, (jp, batches) in cases.items():
        mb = FAMILY_TRAIN_CASES[name][4]
        cfg = family_train_config(name)
        params = from_reference(jp, cfg, "cpu")
        local = steps.shard_train_state({"params": params, "opt": init_opt_state(params)},
                                        cfg, mesh)
        step = steps.make_sharded_train_step(cfg, mesh, OptConfig(**TRAIN_OPT), mb)
        calls.update(moe_shard_map=0, own_rows=0)
        metrics = []
        for b in batches:
            local, m = step(local, steps.shard_train_batch(b, mesh, mb))
            metrics.append({k: float(v) for k, v in m.items()})
        whole = steps.unshard_train_state(local, cfg, mesh)
        out[name] = dict(metrics=metrics, calls=dict(calls),
                         shapes={k: tuple(v.shape) for k, v in leaves(local["params"])},
                         state=({k: v.numpy() for k, v in leaves(whole)} if rank == 0
                                else None))
    if loop_dir is not None:
        cfg = family_loop_config()
        dc = DataConfig(global_batch=4, seq_len=16)

        def run(sub, **kw):
            tc = train_loop.TrainLoopConfig(total_steps=4, ckpt_dir=os.path.join(loop_dir, sub),
                                            ckpt_every=2, log_every=100)
            return train_loop.train(cfg, dc, tc, device="cpu", mesh=mesh, **kw)

        whole = run("whole")
        try:
            run("restart", fail_at_step=3)
            failed = None
        except RuntimeError as e:
            failed = str(e)
        again = run("restart")
        final = steps.unshard_train_state(whole["final_state"], cfg, mesh)
        out["loop"] = dict(losses=whole["losses"], failed=failed, restarted=again["losses"],
                           final=({k: v.numpy() for k, v in leaves(final)} if rank == 0
                                  else None))
    return out


# tests/test_torch_pipeline.py: (n_stages, n_micro) -> the mesh the pipe
# axis sits in; a pipe of 2 on 4 ranks is the minor axis of (data, pipe)
PIPE_CASES = {(4, 8): ((4,), ("pipe",)), (4, 2): ((4,), ("pipe",)),
              (2, 1): ((2, 2), ("data", "pipe"))}


def pipe_rank(rank, world, backend, cases, layers):
    """pipeline_apply of the tanh(x @ w + b) stage for each case of
    PIPE_CASES, with the gradients of sum(out * r); then reduced tinyllama
    layers, two a stage on a (data, pipe) = (2, 2) mesh, at fp32."""
    import numpy as np
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import pipeline as pp
    from repro_torch.models import lm
    from repro_torch.models.params import tree_map

    out = {}
    for key, (w, b, mbs, r) in cases.items():
        shape, names = PIPE_CASES[key]
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=names)
        w, b, x = (torch.tensor(a, requires_grad=True) for a in (w, b, mbs))
        mine = tuple(t.detach().requires_grad_() for t in pp.stage_params((w, b), mesh))
        y = pp.pipeline_apply(lambda p, v: torch.tanh(v @ p[0] + p[1]), mine, x, mesh)
        (y * torch.from_numpy(r)).sum().backward()
        out[key] = (mesh.get_local_rank("pipe"), y.detach().numpy(), mine[0].grad.numpy(),
                    mine[1].grad.numpy(), x.grad.numpy())
    cfg, params, tokens = layers
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "pipe"))
    n_stages = 2
    per = cfg.n_layers // n_stages
    params = tree_map(torch.from_numpy, params)
    kinds = cfg.layer_kinds()
    # every layer's subtree stacked [n_stages, per, ...], cut to this stage's
    stacked = tree_map(lambda *ls: torch.stack(ls).reshape((n_stages, per) + ls[0].shape),
                       *lm._layers(cfg, params))

    def stage_fn(sub, x):
        for i in range(per):
            x, _, _ = lm._sublayer(x, tree_map(lambda t: t[i], sub), None, cfg, kinds[i],
                                   train=True, cache_len=0, pos_offset=None)
        return x

    tok = torch.from_numpy(tokens)
    with torch.no_grad():
        mbs = torch.stack([lm._embed(params, t, cfg) for t in tok])
        y = pp.pipeline_apply(stage_fn, pp.stage_params(stacked, mesh), mbs, mesh)
        got = torch.stack([lm.L.rmsnorm(v, params["final_ln"], cfg.norm_eps) for v in y])
        want = torch.stack([lm.forward(params, t, cfg, mode="train")[0] for t in tok])
    out["layers"] = (got.numpy(), want.numpy())
    return out


def vocab_loss_rank(rank, world, backend, shape, cfg, w, x, labels, chunks):
    """tests/test_torch_train_memory.py: `lm.softmax_xent_chunked` on a
    (data, model) mesh from this rank's rows of x [B, S, D] (over `data`)
    and its vocab columns of the head w [D, padded vocab] (over `model`),
    at each sequence chunk of `chunks`, with the logits kept cut (the
    port's loss) and with them gathered over the vocab
    (`lm.logits_from_hidden`, then the lse and the gold pick): {(chunk,
    "cut" or "gathered"): (nll, z term, loss = nll + 1e-4 z) and the
    gradients of the rank's x and w, numpy}."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed import ctx as dctx
    from repro_torch.models import lm

    def gathered_chunk(params, xc, lc, cfg):
        logits = lm.logits_from_hidden(params, xc, cfg)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, torch.clamp(lc, min=0).long()[..., None])[..., 0]
        mask = (lc >= 0).float()
        return torch.sum((lse - gold) * mask), torch.sum(lse * lse * mask), torch.sum(mask)

    torch.set_num_threads(1)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    (d, m), (nd, nm) = (mesh.get_local_rank("data"), mesh.get_local_rank("model")), shape
    rows, cols = x.shape[0] // nd, w.shape[1] // nm
    xs = torch.from_numpy(x[d * rows:(d + 1) * rows])
    ws = torch.from_numpy(w[:, m * cols:(m + 1) * cols])
    lab = torch.from_numpy(labels[d * rows:(d + 1) * rows])
    out = {}
    for chunk in chunks:
        for name, chunk_fn in (("cut", lm._xent_chunk), ("gathered", gathered_chunk)):
            xg, wg = xs.clone().requires_grad_(), ws.clone().requires_grad_()
            own = lm._xent_chunk
            lm._xent_chunk = chunk_fn
            try:
                with dctx.mesh_context(mesh):
                    nll, z2 = lm.softmax_xent_chunked({"lm_head": wg}, xg, lab, cfg,
                                                      chunk=chunk)
                    loss = nll + 1e-4 * z2
                    loss.backward()
            finally:
                lm._xent_chunk = own
            out[chunk, name] = dict(nll=nll.item(), z2=z2.item(), loss=loss.item(),
                                    gx=xg.grad.numpy(), gw=wg.grad.numpy())
    return out
