"""Secure-aggregation FedAvg: the pairwise-mask round and the host-side
Paillier parity classes.

The counterpart of ``idc_models_tpu/secure/fedavg.py`` on one card
(world size 1). Each round every client trains E local epochs on its
private shard from the incoming global weights; then, at the round
boundary (`secure_aggregate`):

- the first `percent` fraction of the full get_weights() enumeration
  (params and BN moving statistics interleaved in model layer order,
  secure_fed_model.py:115-121) is packed into one f32 buffer per client,
  in the JAX package's leaf order, quantized to int32 and masked with
  antisymmetric pairwise streams; the int32 sum over clients (mod 2^32)
  is the sum of the plain quantized values, bit for bit, because the
  masks cancel; it is dequantized to the unweighted mean (quirk Q7);
- everything else rides a plain f32 mean.

``mask_impl`` picks the mask: ``"threefry"`` (default; the JAX package's
threefry streams, bit-identical per client), ``"pallas"`` (the fused
clip + quantize + hash-PRG mask pass, ``ops/secure_masking_kernel.py``:
the CUDA kernel on a CUDA tensor, its plain version on a CPU one; the
name is the JAX package's, kept so commands carry over), or ``"auto"``
(`resolve_mask_impl`). The hash PRG is fast but not cryptographic, which
is why threefry stays the default: mask unpredictability against a
curious aggregator is what the protocol is for. Both impls aggregate
bit-identically.

Protected BN state is divided by ``_STATE_PRESCALE`` before quantization
and multiplied back after: moving variances run far beyond the +-64 clip
range sized for weights.

The host-side `PaillierClient` / `PaillierServer` reproduce the
reference's object-level protocol (Client.client_fit / enc_model /
client_update, Server.aggregate, secure_fed_model.py:101-168) with the
from-scratch `secure.paillier`.
"""

from __future__ import annotations

import copy
from collections.abc import Callable

import numpy as np
import torch
from torch import nn

from idc_models_tpu_torch import resolve_device
from idc_models_tpu_torch.data.idc import ArrayDataset
from idc_models_tpu_torch.federated import robust
from idc_models_tpu_torch.federated.fedavg import (
    ServerState, Tree, finite_clients, load_server, make_local_trainer,
)
from idc_models_tpu_torch.models import core
from idc_models_tpu_torch.ops import secure_masking_kernel as smk
from idc_models_tpu_torch.secure import masking
from idc_models_tpu_torch.secure.paillier import (
    PaillierPrivateKey, PaillierPublicKey,
)

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# Protected BN state rides the int path at 1/256 scale: the power-of-two
# prescale is exact in f32, extends the state range to +-16384 and costs
# state resolution only (256 * 2^-scale_bits ~ 1e-4).
_STATE_PRESCALE = 256.0

MASK_IMPLS = ("threefry", "pallas", "auto")


def _layer_order(model: nn.Module):
    return getattr(model, "layer_names", None)


def resolve_mask_impl(model: nn.Module, percent: float, *,
                      device) -> str:
    """Resolve ``mask_impl="auto"``: the CUDA kernel iff the round runs on
    a CUDA device AND the protected buffer reaches
    `masking.MASK_PALLAS_MIN_ELEMS`; threefry otherwise."""
    if torch.device(device).type != "cuda":
        return "threefry"
    params = dict(model.named_parameters())
    state = dict(model.named_buffers())
    pf, sf = masking.first_fraction_selection_weights(
        params, state, percent, _layer_order(model))
    n_prot = (sum(params[n].numel() for n, f in pf.items() if f)
              + sum(state[n].numel() for n, f in sf.items() if f))
    return ("pallas" if n_prot >= masking.MASK_PALLAS_MIN_ELEMS
            else "threefry")


def _secure_aggregator(spec) -> robust.Aggregator:
    if spec in robust.ORDER_STATISTIC or (
            isinstance(spec, robust.Aggregator)
            and not spec.secure_compatible):
        raise ValueError(
            f"aggregator {spec!r} is not compatible with secure "
            f"aggregation: the masked path sums quantized per-client "
            f"contributions, so only per-client-transform + mean "
            f"aggregators (mean, norm_clip) can ride it; trimmed_mean/"
            f"median need plaintext cross-client views, which the "
            f"protocol exists to prevent — use the plain "
            f"make_fedavg_round for those")
    return robust.get_aggregator(spec)


def _masked_sum(flat: torch.Tensor, sb: int, clip_abs: float,
                mask_impl: str, mask_key: masking.Key) -> torch.Tensor:
    """Σ_i (quantize(flat[i]) + mask_i) mod 2^32 over the C client rows
    of `flat` [C, P], as int32: the server's view of the protected sum."""
    n = flat.shape[0]
    total = torch.zeros(flat.shape[1], dtype=torch.int64, device=flat.device)
    if mask_impl == "pallas":
        seed = masking.random_bits_scalar(mask_key)
        for i in range(n):
            seeds, signs = smk.pair_seeds_and_signs(seed, i, n,
                                                    device=flat.device)
            total += smk.fused_masked_quantize(
                flat[i], seeds, signs, scale_bits=sb, clip_abs=clip_abs)
    else:
        q = masking.quantize(flat, sb, clip_abs=clip_abs)
        for i in range(n):
            total += q[i]
            total += masking.pairwise_mask(mask_key, i, n, (flat.shape[1],),
                                           device=flat.device)
    return smk.wrap_int32(total)


def secure_aggregate(client_params: Tree, client_state: Tree,
                     global_params: Tree, global_state: Tree, *,
                     percent: float, layer_order=None,
                     scale_bits: int | None = None,
                     clip_abs: float = masking.DEFAULT_CLIP_ABS,
                     mask_impl: str = "threefry",
                     mask_key: masking.Key = (0, 0),
                     live: torch.Tensor | None = None, aggregator=None
                     ) -> tuple[Tree, Tree, dict[str, torch.Tensor]]:
    """The secure round boundary over C clients' updates.

    `client_params` / `client_state` hold each client's weights stacked on
    a leading [C] axis; `global_*` are the incoming global weights (the
    aggregator's reference and the selection's shapes). `mask_key` is a
    threefry key as two 32-bit words (``jax.random.key_data``); `live`
    ([C] bool) marks the clients whose aggregator metrics count.

    Returns ``(params, state, metrics)``: the unweighted mean, whose
    protected part is exactly ``dequantize(Σ quantize(x_i))``, and the
    metrics ``clip_saturated`` (protected elements at or beyond
    ±clip_abs over all clients) plus the aggregator's counts, as device
    scalars."""
    if mask_impl not in ("threefry", "pallas"):
        raise ValueError(f"unknown mask_impl {mask_impl!r}")
    agg = _secure_aggregator(aggregator)
    p_names = masking.leaf_names(global_params)
    s_names = masking.leaf_names(global_state)
    updates = {n: client_params[n] for n in p_names}
    updates.update({n: client_state[n] for n in s_names})
    n_clients = updates[p_names[0]].shape[0]
    device = updates[p_names[0]].device
    live = (torch.ones(n_clients, dtype=torch.bool, device=device)
            if live is None else live)
    sb = (scale_bits if scale_bits is not None
          else masking.choose_scale_bits(n_clients, clip_abs))

    updates, per_client_m = agg.per_client(
        updates, {**global_params, **global_state})
    metrics = {k: torch.where(live, v, 0.0).sum()
               for k, v in per_client_m.items()}

    p_flags, s_flags = masking.first_fraction_selection_weights(
        global_params, global_state, percent, layer_order)
    flags = {**p_flags, **s_flags}
    names = p_names + s_names
    is_state = set(s_names)
    prot = [n for n in names if flags[n]]
    plain = [n for n in names if not flags[n]]
    out: Tree = {}

    metrics["clip_saturated"] = torch.zeros((), device=device)
    if prot:
        flat, meta = masking.pack_leaves(
            [updates[n] / _STATE_PRESCALE if n in is_state else updates[n]
             for n in prot], lead_axes=1)
        metrics["clip_saturated"] = (flat.abs() >= clip_abs).sum().float()
        summed = _masked_sum(flat.contiguous(), sb, clip_abs, mask_impl,
                             mask_key)
        deq = masking.dequantize(summed, sb, count=n_clients)
        for n, x in zip(prot, masking.unpack_leaves(deq, meta)):
            out[n] = x * _STATE_PRESCALE if n in is_state else x

    if plain:
        flat, meta = masking.pack_leaves([updates[n] for n in plain],
                                         lead_axes=1)
        acc = flat[0]
        for i in range(1, n_clients):   # in client order, on every device
            acc = acc + flat[i]
        mean = acc / torch.tensor(float(n_clients), device=device)
        out.update(zip(plain, masking.unpack_leaves(mean, meta)))

    return ({n: out[n] for n in p_names}, {n: out[n] for n in s_names},
            metrics)


def make_secure_fedavg_round(model: nn.Module, lr: float, loss_fn: LossFn,
                             *, percent: float, local_epochs: int = 5,
                             batch_size: int = 32,
                             scale_bits: int | None = None,
                             clip_abs: float = masking.DEFAULT_CLIP_ABS,
                             mask_impl: str = "threefry",
                             recover_nonfinite: bool = True,
                             aggregator=None, device=None):
    """Build the one-round secure-FedAvg program on one card.

    Returns ``round_fn(server, images [C, S, ...], labels [C, S],
    generator) -> (server, metrics)``. `model` is the working module: it
    moves to `device` (CUDA unless "cpu" is asked for), and each client
    trains on it in turn from the server's weights. `generator` draws the
    round's threefry mask key and each client's seed; client c trains
    with its own device generator, so a run replays from (seed, round,
    client id). The metrics are the JAX package's: ``loss`` and
    ``accuracy`` (means over the live clients' local steps, NaN if none
    survived), ``clients_recovered``, ``clip_saturated`` and the
    aggregator's counts, as floats.

    ``recover_nonfinite`` (default on): a client whose update goes
    non-finite contributes the incoming global weights instead -- a no-op
    that keeps its pairwise masks cancelling and the divisor intact --
    and is left out of the training metrics.

    `scale_bits` defaults to the largest fixed-point precision whose sum
    over the clients of clipped values cannot overflow int32
    (`masking.choose_scale_bits`)."""
    _secure_aggregator(aggregator)
    if mask_impl not in MASK_IMPLS:
        raise ValueError(f"unknown mask_impl {mask_impl!r}")
    device = resolve_device(device)
    model.to(device)
    if mask_impl == "auto":
        mask_impl = resolve_mask_impl(model, percent, device=device)
    local_train = make_local_trainer(model, lr, loss_fn,
                                     local_epochs=local_epochs,
                                     batch_size=batch_size)

    def round_fn(server: ServerState, images, labels,
                 generator: torch.Generator):
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        labels = torch.as_tensor(labels, device=device)
        server = server.replace(
            params={k: v.to(device) for k, v in server.params.items()},
            state={k: v.to(device) for k, v in server.state.items()})
        n = images.shape[0]
        words = torch.randint(0, 2 ** 32, (2 + n,), generator=generator,
                              dtype=torch.int64,
                              device=generator.device).tolist()
        mask_key, client_seeds = (words[0], words[1]), words[2:]
        stacked = {k: torch.empty((n,) + v.shape, dtype=v.dtype,
                                  device=device)
                   for k, v in {**server.params, **server.state}.items()}
        losses, accs = [], []
        for c in range(n):
            load_server(model, server)
            gen = torch.Generator(device=device).manual_seed(client_seeds[c])
            loss, acc = local_train(images[c], labels[c], gen)
            losses.append(loss.mean())
            accs.append(acc.mean())
            with torch.no_grad():
                for k, v in model.state_dict().items():
                    stacked[k][c].copy_(v)
        losses, accs = torch.stack(losses), torch.stack(accs)
        client_p = {k: stacked[k] for k in server.params}
        client_s = {k: stacked[k] for k in server.state}

        ok = torch.ones(n, dtype=torch.bool, device=device)
        if recover_nonfinite:
            ok = finite_clients(losses, client_p, client_s)
            for k, v in {**server.params, **server.state}.items():
                stacked[k][~ok] = v
        params, state, m = secure_aggregate(
            client_p, client_s, server.params, server.state,
            percent=percent, layer_order=_layer_order(model),
            scale_bits=scale_bits, clip_abs=clip_abs, mask_impl=mask_impl,
            mask_key=mask_key, live=ok, aggregator=aggregator)

        alive = ok.sum()
        nan = torch.tensor(float("nan"), device=device)
        for k, v in (("loss", losses), ("accuracy", accs)):
            m[k] = torch.where(ok, v, 0.0).sum() / alive
        m["clients_recovered"] = (~ok).sum().float()
        m["clip_saturated"] = torch.where(alive > 0, m["clip_saturated"],
                                          nan)
        m = dict(zip(m, torch.stack(list(m.values())).tolist()))
        return ServerState(server.round + 1, params, state), m

    return round_fn


# ---------------------------------------------------------------------------
# Host-side Paillier parity mode (the reference's actual mechanism)
# ---------------------------------------------------------------------------

class PaillierClient:
    """Object-level parity with the reference's `Client`
    (secure_fed_model.py:101-154): owns a model replica and a private
    shard; trains locally, encrypts the first ``int(L * percent)`` weight
    tensors scalar by scalar, decrypts aggregates, and adopts them."""

    def __init__(self, model: nn.Module, lr: float, loss_fn: LossFn,
                 images: np.ndarray, labels: np.ndarray, client_id: int,
                 percent: float, public_key: PaillierPublicKey,
                 private_key: PaillierPrivateKey, *,
                 local_epochs: int = 5, batch_size: int = 32, seed: int = 0,
                 device=None):
        device = resolve_device(device)
        self.model = core.init_params(copy.deepcopy(model), seed).to(device)
        self.percent = percent
        self.public_key = public_key
        self.private_key = private_key
        self.images = torch.as_tensor(np.asarray(images), dtype=torch.float32,
                                      device=device)
        self.labels = torch.as_tensor(np.asarray(labels), device=device)
        self.client_id = client_id
        self._trainer = make_local_trainer(self.model, lr, loss_fn,
                                           local_epochs=local_epochs,
                                           batch_size=batch_size)
        self._generator = torch.Generator(device=device).manual_seed(
            (seed + 1) * 1_000_003 + client_id)

    @property
    def params(self) -> Tree:
        return dict(self.model.named_parameters())

    @property
    def model_state(self) -> Tree:
        return dict(self.model.named_buffers())

    def _flat_weights(self):
        """All model weights -- params AND BN moving statistics, as Keras
        get_weights() lists them -- as float64 arrays in model layer
        order. Returns (ordered arrays, restore fn)."""
        tensors = {**self.params, **self.model_state}
        names = (masking.leaf_names(self.params)
                 + masking.leaf_names(self.model_state))
        order = masking.ranked_indices([tuple(n.split(".")) for n in names],
                                       _layer_order(self.model))
        ordered = [tensors[names[i]].detach().cpu().numpy().astype(np.float64)
                   for i in order]

        def restore(ordered_tensors):
            with torch.no_grad():
                for slot, t in zip(order, ordered_tensors):
                    dst = tensors[names[slot]]
                    dst.copy_(torch.as_tensor(np.asarray(t, np.float32)))

        return ordered, restore

    def _num_encrypted(self) -> int:
        return int((len(self.params) + len(self.model_state)) * self.percent)

    def client_fit(self):
        """Local epochs, then the (partially encrypted) weights out
        (secure_fed_model.py:131-141)."""
        losses, accs = self._trainer(self.images, self.labels,
                                     self._generator)
        stats = (losses.cpu().numpy(), accs.cpu().numpy())
        return self.enc_model(), stats

    def enc_model(self):
        """Flat list of weight tensors in model layer order; the first
        ``int(L * percent)`` are object arrays of EncryptedNumber
        (secure_fed_model.py:115-121)."""
        leaves, _ = self._flat_weights()
        n_enc = self._num_encrypted()
        enc = np.vectorize(self.public_key.encrypt, otypes=[object])
        return [enc(leaf) if i < n_enc else leaf
                for i, leaf in enumerate(leaves)]

    def dec_model(self, tensors):
        n_enc = self._num_encrypted()
        dec = np.vectorize(self.private_key.decrypt, otypes=[np.float64])
        return [dec(t) if i < n_enc else t for i, t in enumerate(tensors)]

    def client_update(self, aggregated):
        """Decrypt and adopt the aggregate, params and moving statistics
        both (secure_fed_model.py:143-149)."""
        _, restore = self._flat_weights()
        restore(self.dec_model(aggregated))

    def evaluate(self, images: np.ndarray, labels: np.ndarray,
                 loss_fn: LossFn) -> dict[str, float]:
        """loss / binary accuracy / AUROC on a held-out set
        (secure_fed_model.py:152-154 with the AUROC metric)."""
        from idc_models_tpu_torch.train.loop import evaluate

        return evaluate(self.model, ArrayDataset(images, labels), loss_fn,
                        batch_size=max(len(images), 1), with_auroc=True)


class PaillierServer:
    """Parity with the reference's stateless `Server.aggregate`
    (secure_fed_model.py:156-168): elementwise unweighted mean per tensor,
    on EncryptedNumber object arrays (homomorphic add and scalar divide)
    and plain ndarrays alike."""

    @staticmethod
    def aggregate(client_weights):
        n = len(client_weights)
        out = []
        for tensors in zip(*client_weights):
            acc = tensors[0]
            for t in tensors[1:]:
                acc = acc + t
            out.append(acc / n)
        return out
