"""FederatedTrainer — the paper's cross-cloud training loop (the reference's
``core/federated.py``, simulation mode).

Per the paper:
  §3.2 local-update schedule: H local AdamW steps between sync rounds.
  §3.2 compression: each cloud's delta passes the Compressor channel, with
       error feedback.
  §3.3 aggregation: fedavg | dynamic | gradient | async (formulas 1-4).
  §3.1 security: DP clipping of each cloud's update, Gaussian noise on the
       aggregate.

Where the reference stacks per-cloud state on a leading axis under
``jax.vmap``, the port keeps a list of per-cloud states and loops over it
(counted over meta tensors, ``utils/cost.scan_range``, one cloud's local
step stands for all of them); ``lax.cond`` on the sync round becomes
``if step % H == 0``.

Pod mode (``spmd_axis="pod"`` with a ``mesh`` of one device per cloud,
``launch/mesh.make_sim_mesh``; the reference's SPMD mode): cloud i's
parameters, moments and error feedback live on pod device i and its local
steps run there; the global parameters live on the combining device, the
mesh's first. The channel takes the reference's SPMD codecs
(``Compressor(spmd=True)``), and a ``wire_int8`` sync (fedavg or dynamic;
refused without pod mode and under async or gradient aggregation) carries
each cloud's transmitted update to the combining device as int8 rows
(``aggregation.int8_wire_weighted_average``); otherwise the updates move
there in fp32. All pods may share one device (the CPU, one card).

The state is updated in place and returned. The sync round streams leaf by leaf: a
cloud's fp32 delta is made when a leaf is reached (twice under DP: once for
the norm, once to send), so a full-width sync holds a few leaves of fp32
temporaries instead of whole delta trees. Deltas, error feedback and the
aggregate are fp32, cast where the reference casts.

State: {"clouds": [{"params", "opt"}] per cloud, "global": {"params",
"outer"}, "sample_counts" (C,), "loss_accum" (C,), "step" int, "rng" (the
DP noise generator, on the training device), "ef": [fp32 tree] per cloud
when compression runs with error feedback}."""
from __future__ import annotations

import dataclasses
from typing import Any, Iterator

import torch

from repro_torch.configs.base import FederatedConfig, TrainConfig
from repro_torch.core import aggregation as agg
from repro_torch.core import privacy
from repro_torch.core.compression import Compressor
from repro_torch.kernels import ops
from repro_torch.models.model import ModelAPI
from repro_torch.optim.adamw import adamw_init, adamw_update, clip_scale
from repro_torch.optim.outer import outer_init, outer_update
from repro_torch.utils import cost
from repro_torch.utils.grad import microbatched_value_and_grad
from repro_torch.utils.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class FederatedTrainer:
    model: ModelAPI
    fed: FederatedConfig
    train: TrainConfig
    spmd_axis: str | None = None     # "pod": pod mode over ``mesh``
    microbatches: int = 1            # grad-accumulation chunks per local step
    mesh: Any = None                 # the pod mesh (one device per cloud)

    def __post_init__(self):
        self.compressor = Compressor(self.fed.compression, self.fed.topk_ratio,
                                     spmd=self.spmd_axis is not None)
        if self.fed.aggregation not in agg.AGGREGATORS:
            raise ValueError(f"unknown aggregation {self.fed.aggregation!r}")
        if self.spmd_axis is not None:
            pods = dict(self.mesh.shape).get(self.spmd_axis) if self.mesh is not None else None
            if pods != self.fed.n_clouds:
                raise ValueError(f"pod mode needs a mesh with a {self.spmd_axis!r} axis of "
                                 f"{self.fed.n_clouds} devices (one per cloud), got {self.mesh}")
        # the int8 wire is the pod-mode sync of formulas 1-2: refuse it
        # where the sync would silently move fp32 instead
        if self.fed.wire_int8 and self.spmd_axis is None:
            raise ValueError("wire_int8 needs pod mode (spmd_axis='pod' and a pod mesh)")
        if self.fed.wire_int8 and self.fed.aggregation in ("async", "gradient"):
            raise ValueError(f"wire_int8 with {self.fed.aggregation!r} aggregation: the int8 "
                             "wire carries the fedavg/dynamic sync only")
        # declared as in the reference, which reads neither: refuse them
        # rather than train without the masking or evaluation they ask for
        if self.fed.secure_agg:
            raise ValueError("secure_agg: the trainer does not mask its sync; call "
                             "core.privacy.secure_aggregate on the clouds' updates")
        if self.train.eval_every:
            raise ValueError("eval_every: the trainer has no evaluation loop")
        # the synthetic corpus has tokens only, where these families' losses
        # read patch or audio embeddings (the reference's trainer fails on
        # them with a KeyError in loss_fn)
        inputs = {"vlm": "patch_embeds", "audio": "audio_embeds"}
        if self.model.cfg.arch_type in inputs:
            raise ValueError(
                f"{self.model.cfg.name} ({self.model.cfg.arch_type}): its loss needs "
                f"{inputs[self.model.cfg.arch_type]!r}, and the federated corpus carries "
                "tokens only")

    # ------------------------------------------------------------------ init
    def _cloud_device(self, c: int, device):
        """Where cloud c's state lives: its pod device in pod mode."""
        return self.mesh.devices[c] if self.spmd_axis is not None else torch.device(device)

    def init_state(self, generator: torch.Generator, device, *,
                   noise_seed: int = 0xFED) -> dict:
        """Fresh weights from ``generator`` on ``device``, copied to every
        cloud (to its pod device in pod mode); the DP noise generator is
        seeded with ``noise_seed`` on ``device``. In pod mode ``device`` is
        the mesh's first device, the combining device."""
        c = self.fed.n_clouds
        if self.spmd_axis is not None:
            device = self.mesh.devices[0]
        params = self.model.init(generator, device)
        counts = self.fed.cloud_sample_counts or (1,) * c
        clouds = [tree_map(lambda p, i=i: p.to(self._cloud_device(i, device), copy=True), params)
                  for i in range(c)]
        state = {
            "clouds": [{"params": cp, "opt": adamw_init(cp)} for cp in clouds],
            "global": {"params": params, "outer": outer_init(self.fed, params)},
            "sample_counts": torch.tensor(counts, dtype=torch.float32, device=device),
            "loss_accum": torch.zeros(c, dtype=torch.float32, device=device),
            "step": 0,
            "rng": torch.Generator(device=device).manual_seed(noise_seed),
        }
        if self._use_error_feedback():
            state["ef"] = [tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), cp)
                           for cp in clouds]
        return state

    def _use_error_feedback(self) -> bool:
        return self.fed.compression != "none" and self.fed.error_feedback

    # ------------------------------------------------------------ local step
    def _grads(self, params: dict, batch: dict):
        model_batch = {k: v for k, v in batch.items() if k != "domain"}
        return microbatched_value_and_grad(self.model.loss, params, model_batch,
                                           self.microbatches)

    def _local_step(self, cloud: dict, batch: dict) -> dict:
        (_, metrics), grads = self._grads(cloud["params"], batch)
        adamw_update(self.train, grads, cloud["opt"], cloud["params"])
        return metrics

    # ----------------------------------------------------- transmitted delta
    def _channel(self, deltas: list, ef: list | None, n_leaves: int) -> Iterator[list]:
        """Compression channel + error feedback + DP clipping, per cloud.

        ``deltas[c](i)`` makes cloud c's fp32 update of leaf i; ``ef[c]`` is
        cloud c's list of fp32 error-feedback leaves (updated in place) or
        None. Yields, leaf by leaf, the list of the clouds' transmitted
        leaves."""
        fed = self.fed

        def update(c, i):
            d = deltas[c](i)
            return d + ef[c][i] if ef is not None else d

        scales = [None] * len(deltas)
        if fed.dp_clip > 0:
            scales = [clip_scale(ops.tree_sq_norm(update(c, i) for i in range(n_leaves)),
                                 fed.dp_clip) for c in range(len(deltas))]
        for i in range(n_leaves):
            sent = []
            for c, scale in enumerate(scales):
                d = update(c, i)
                if scale is not None:
                    d = ops.clip_noise(d, scale)
                if fed.compression != "none":
                    t = self.compressor.roundtrip_leaf(d)
                    if ef is not None:
                        ef[c][i].copy_(d - t)
                    d = t
                sent.append(d)
            yield sent

    def _noise_std(self) -> float:
        fed = self.fed
        if fed.dp_clip > 0 and fed.dp_noise_mult > 0:
            return privacy.dp_noise_stddev(fed.dp_clip, fed.dp_noise_mult, fed.n_clouds)
        return 0.0

    # ------------------------------------------------------------ sync round
    @torch.no_grad()
    def _sync(self, state: dict, arrived: torch.Tensor, alphas: torch.Tensor) -> dict:
        fed = self.fed
        g = state["global"]["params"]
        g_leaves = tree_leaves(g)
        clouds = [tree_leaves(cl["params"]) for cl in state["clouds"]]
        ef = [tree_leaves(e) for e in state["ef"]] if "ef" in state else None

        def delta(c):
            return lambda i: clouds[c][i].float() - g_leaves[i].to(clouds[c][i].device).float()

        mean_losses = state["loss_accum"] / max(fed.local_steps, 1)
        if fed.aggregation == "dynamic":
            weights = agg.dynamic_weights(mean_losses, fed.dynamic_temp)
        else:
            weights = agg.fedavg_weights(state["sample_counts"])
        std = self._noise_std()

        new_leaves = []
        channel = self._channel([delta(c) for c in range(len(clouds))], ef, len(g_leaves))
        for gl, sent in zip(g_leaves, channel):
            if fed.aggregation == "async":
                # reconstructed per-cloud params after the lossy channel
                recon = [gl.float() + t.to(gl.device) for t in sent]
                new_leaves.append(agg.masked_async_update(gl, recon, alphas, arrived))
                continue
            if fed.wire_int8:
                # each cloud's int8 rows and row scales move to the combining device
                d = agg.int8_wire_weighted_average(sent, weights, pod_axis=self.spmd_axis,
                                                   mesh=self.mesh)
            else:
                d = agg.weighted_average([t.to(gl.device) for t in sent], weights)
            if std > 0:
                d = privacy.add_gaussian_noise(d, state["rng"], std)
            new_leaves.append((gl.float() + d.float()).to(gl.dtype))
        aggregated = tree_unflatten(g, new_leaves)

        if fed.aggregation == "async":
            new_global, outer_state = aggregated, state["global"]["outer"]
            # only arrived clouds pull the fresh global model
            pull = [c for c, a in enumerate(arrived.tolist()) if a]
        else:
            new_global, outer_state = outer_update(fed, g, aggregated,
                                                   state["global"]["outer"])
            pull = range(fed.n_clouds)
        for c in pull:
            for p, ng in zip(clouds[c], tree_leaves(new_global)):
                p.copy_(ng)
        state["global"] = {"params": new_global, "outer": outer_state}
        state["loss_accum"] = torch.zeros_like(state["loss_accum"])
        return state

    # ------------------------------------------------------------ train step
    def train_step(self, state: dict, batch_stack: dict, arrived: torch.Tensor | None = None,
                   alphas: torch.Tensor | None = None) -> tuple[dict, dict]:
        """One global step: a local step on every cloud (+ a sync round every
        H steps). batch_stack leaves: (n_clouds, B, ...) on the state's
        device. For async mode pass the scheduler's (arrived, alphas) row
        for this round."""
        fed = self.fed
        c = fed.n_clouds
        device = state["loss_accum"].device
        if arrived is None:
            arrived = torch.ones(c, dtype=torch.bool, device=device)
        if alphas is None:
            alphas = torch.full((c,), fed.async_alpha, dtype=torch.float32, device=device)
        if fed.aggregation == "gradient":
            return self._gradient_step(state, batch_stack)

        metrics = cost.fill_steps(
            [self._local_step(state["clouds"][i], self._cloud_batch(batch_stack, i, device))
             for i in cost.scan_range(c, like=state["loss_accum"])], c)
        losses = torch.stack([m["loss"].to(device) for m in metrics])
        accs = torch.stack([m["accuracy"].to(device) for m in metrics])
        state["loss_accum"] = state["loss_accum"] + losses
        state["step"] += 1
        synced = state["step"] % max(fed.local_steps, 1) == 0
        if synced:
            self._sync(state, arrived, alphas)
        return state, {"loss": losses.mean(), "accuracy": accs.mean(),
                       "per_cloud_loss": losses, "synced": float(synced)}

    def _cloud_batch(self, batch_stack: dict, i: int, device) -> dict:
        """Cloud i's batch, on its device."""
        dev = self._cloud_device(i, device)
        return {k: v[i].to(dev) for k, v in batch_stack.items()}

    # ------------------------------------------------- gradient aggregation
    def _gradient_step(self, state: dict, batch_stack: dict) -> tuple[dict, dict]:
        """Formula 3: aggregate ∇w_i every step, one global optimizer."""
        fed = self.fed
        device = state["loss_accum"].device
        grads, metrics = [], []
        for i, cloud in enumerate(state["clouds"]):
            (_, m), gr = self._grads(cloud["params"], self._cloud_batch(batch_stack, i, device))
            grads.append(tree_leaves(gr))
            metrics.append(m)
        g = state["global"]["params"]
        ef = [tree_leaves(e) for e in state["ef"]] if "ef" in state else None
        weights = agg.fedavg_weights(state["sample_counts"])
        std = self._noise_std()
        agg_leaves = []
        with torch.no_grad():
            channel = self._channel([(lambda i, gc=gc: gc[i]) for gc in grads], ef,
                                    len(grads[0]))
            for sent in channel:
                d = agg.gradient_aggregate(None, [t.to(device) for t in sent], weights)
                agg_leaves.append(privacy.add_gaussian_noise(d, state["rng"], std)
                                  if std > 0 else d)
        del grads
        # one global optimizer step; cloud 0's optimizer state is canonical
        opt0 = state["clouds"][0]["opt"]
        adamw_update(self.train, tree_unflatten(g, agg_leaves), opt0, g)
        with torch.no_grad():
            for c, cloud in enumerate(state["clouds"]):
                for p, gp in zip(tree_leaves(cloud["params"]), tree_leaves(g)):
                    p.copy_(gp)
                if c:
                    for name in ("m", "v"):
                        for x, x0 in zip(tree_leaves(cloud["opt"][name]),
                                         tree_leaves(opt0[name])):
                            x.copy_(x0)
                    cloud["opt"]["count"] = opt0["count"]
        state["step"] += 1
        losses = torch.stack([m["loss"].to(device) for m in metrics])
        accs = torch.stack([m["accuracy"].to(device) for m in metrics])
        return state, {"loss": losses.mean(), "accuracy": accs.mean(),
                       "per_cloud_loss": losses, "synced": 1.0}

    # --------------------------------------------------------- wire accounting
    def sync_bytes_per_cloud(self, params: dict) -> int:
        """Uplink bytes one cloud transmits per sync round."""
        return self.compressor.bytes_per_sync(params)

    def syncs_per_step(self) -> float:
        if self.fed.aggregation == "gradient":
            return 1.0
        return 1.0 / max(self.fed.local_steps, 1)
