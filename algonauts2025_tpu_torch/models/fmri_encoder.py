"""FmriEncoder: the flagship trimodal brain encoder (torch.nn).

The port of algonauts2025_tpu/models/fmri_encoder.py: per-modality linear
projectors -> concat/sum to a 3072-d stream -> learned time positional
embedding (+ optional subject embedding) -> 8-layer rotary transformer ->
per-subject linear readout over parcels -> adaptive-average pooling onto
TRs, with the optional InfoNCE alignment sharing the same trunk pass.

``FmriEncoderConfig.build`` returns a model on the meta device (shapes, no
memory), as flax's ``build`` returns a module without params;
``BrainTrainer.init_state`` allocates it on its device (``to_empty``) and
draws flax's initialisers from a ``torch.Generator`` (``init_weights``).
"""

from __future__ import annotations

import typing as tp

import pydantic
import torch
from torch import nn

from ..ops.pooling import adaptive_avg_pool_matrix
from .common import SubjectLayers
from .transformer import TransformerEncoder, lecun_normal_

__all__ = ["FmriEncoderConfig", "FmriEncoder", "HIDDEN_DIM", "MAX_POSITIONS"]

HIDDEN_DIM = 3072
MAX_POSITIONS = 1024

Batch = tp.Mapping[str, torch.Tensor]


class FmriEncoderConfig(pydantic.BaseModel):
    """Same config surface as the JAX package's FmriEncoderConfig."""

    model_config = pydantic.ConfigDict(extra="forbid")
    name: tp.Literal["FmriEncoder"] = "FmriEncoder"
    n_subjects: int | None = None
    feature_aggregation: tp.Literal["sum", "cat"] = "cat"
    layer_aggregation: tp.Literal["mean", "cat"] = "cat"
    subject_embedding: bool = False
    modality_dropout: float = 0.0

    contrastive_enabled: bool = False
    contrastive_modalities: list[str] = ["video"]
    contrastive_weight: float = 0.1
    contrastive_temperature: float = 0.07

    hidden: int = HIDDEN_DIM
    depth: int = 8
    heads: int = 8
    bf16: bool = False
    remat: bool = False
    #: with remat: selective checkpoint policy ("save_attn_out" keeps each
    #: layer's attention branch output; None = full remat)
    remat_policy: str | None = None

    def build(
        self,
        feature_dims: dict[str, tuple[int, int] | None],
        n_outputs: int,
        n_output_timesteps: int,
        device: str | torch.device = "meta",
    ) -> "FmriEncoder":
        return FmriEncoder(
            feature_dims={k: (tuple(v) if v else None) for k, v in feature_dims.items()},
            n_outputs=n_outputs,
            n_output_timesteps=n_output_timesteps,
            config=self,
            device=device,
        )


class FmriEncoder(nn.Module):
    def __init__(
        self,
        feature_dims: tp.Mapping[str, tuple[int, int] | None],
        n_outputs: int,
        n_output_timesteps: int,
        config: FmriEncoderConfig,
        device: str | torch.device = "meta",
    ) -> None:
        super().__init__()
        cfg = config
        self.config = cfg
        self.feature_dims = dict(feature_dims)
        self.n_outputs = n_outputs
        self.n_output_timesteps = n_output_timesteps
        hidden = cfg.hidden
        n_mod = len(self.feature_dims)
        out_dim = hidden // n_mod if cfg.feature_aggregation == "cat" else hidden
        model_dim = out_dim * n_mod if cfg.feature_aggregation == "cat" else hidden
        if model_dim % cfg.heads:
            raise ValueError(
                f"trunk width {model_dim} (hidden={hidden}, {n_mod} modalities) "
                f"must be divisible by heads={cfg.heads}"
            )
        if cfg.n_subjects is None:
            raise ValueError("n_subjects must be set before build")
        self.model_dim = model_dim
        self.projectors = nn.ModuleDict()
        self.contrastive_heads = nn.ModuleDict()
        for modality, tup in self.feature_dims.items():
            if tup is None:
                continue
            n_layers, dim = tup
            in_dim = dim if cfg.layer_aggregation == "mean" else n_layers * dim
            self.projectors[modality] = nn.Linear(in_dim, out_dim, device=device)
            if cfg.contrastive_enabled and modality in cfg.contrastive_modalities:
                self.contrastive_heads[modality] = nn.Linear(in_dim, hidden, device=device)
        self.time_pos_embed = nn.Parameter(
            torch.empty(1, MAX_POSITIONS, model_dim, device=device)
        )
        self.subject_embed = (
            nn.Embedding(cfg.n_subjects, model_dim, device=device)
            if cfg.subject_embedding
            else None
        )
        self.encoder = TransformerEncoder(
            dim=model_dim,
            depth=cfg.depth,
            heads=cfg.heads,
            attn_dropout=0.0,
            ff_dropout=0.0,
            remat=cfg.remat,
            remat_policy=cfg.remat_policy,
            device=device,
        )
        self.predictor = SubjectLayers(
            in_channels=model_dim,
            out_channels=n_outputs,
            n_subjects=cfg.n_subjects,
            use_bias=True,
            device=device,
        )
        self._pool: dict[tuple[int, int, torch.device], torch.Tensor] = {}

    # -- parameters -------------------------------------------------------
    def init_weights(self, generator: torch.Generator | None = None) -> None:
        """flax's initialisers: lecun-normal Dense kernels, zero biases,
        normal(1.0) pos-embed, N(0, 1/C) readout, N(0, 1/width) embedding."""
        with torch.no_grad():
            for layer in (*self.projectors.values(), *self.contrastive_heads.values()):
                lecun_normal_(layer.weight, generator)
                nn.init.zeros_(layer.bias)
            self.time_pos_embed.normal_(generator=generator)
            if self.subject_embed is not None:
                self.subject_embed.weight.normal_(generator=generator).mul_(
                    self.subject_embed.embedding_dim**-0.5
                )
            self.encoder.init_weights(generator)
            self.predictor.init_weights(generator)

    def _pool_matrix(self, n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
        key = (n_in, n_out, device)
        if key not in self._pool:
            self._pool[key] = torch.from_numpy(adaptive_avg_pool_matrix(n_in, n_out)).to(device)
        return self._pool[key]

    # -- pieces -----------------------------------------------------------
    def _prepare_modality(self, data: torch.Tensor) -> torch.Tensor:
        """(B, L, D, T) or (B, D, T) -> (B, T, D') with layer aggregation."""
        data = data.float()
        if data.dim() == 3:
            data = data[:, None]
        if self.config.layer_aggregation == "mean":
            data = data.mean(dim=1)
        else:
            b, n_layers, d, t = data.shape
            data = data.reshape(b, n_layers * d, t)
        return data.transpose(1, 2)

    def aggregate_features(
        self, batch: Batch, training: bool = False, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        cfg = self.config
        names = list(self.feature_dims)
        n_mod = len(names)
        ref = next(batch[m] for m in names if m in batch)
        b, t = ref.shape[0], ref.shape[-1]

        # modality dropout: one host draw per modality per call, at least
        # one modality survives; the survivor is drawn over all feature_dims
        # entries, zero fillers included, as in the JAX package
        drops = [False] * n_mod
        if training and cfg.modality_dropout > 0:
            draws = torch.rand(n_mod, generator=generator) < cfg.modality_dropout
            keep = int(torch.randint(0, n_mod, (), generator=generator))
            if bool(draws.all()):
                draws[keep] = False
            drops = draws.tolist()

        tensors = []
        for i, modality in enumerate(names):
            if modality not in self.projectors:
                proj_dim = cfg.hidden if cfg.feature_aggregation == "sum" else cfg.hidden // n_mod
                tensors.append(torch.zeros((b, t, proj_dim), device=ref.device))
                continue
            data = self._prepare_modality(batch[modality])
            if cfg.bf16:
                # the flax Dense promotes a bf16 input against its fp32
                # kernel, so bf16 only rounds the features
                data = data.to(torch.bfloat16).float()
            data = self.projectors[modality](data)
            if drops[i]:
                data = torch.zeros_like(data)
            tensors.append(data)
        if cfg.feature_aggregation == "cat":
            return torch.cat(tensors, dim=-1)
        return sum(tensors)

    def transformer_forward(
        self, x: torch.Tensor, subject_id: torch.Tensor | None = None
    ) -> torch.Tensor:
        x = x + self.time_pos_embed[:, : x.shape[1]].to(x.dtype)
        if self.subject_embed is not None and subject_id is not None:
            x = x + self.subject_embed(subject_id.reshape(-1))[:, None, :].to(x.dtype)
        return self.encoder(x)

    def get_brain_latents(
        self, batch: Batch, training: bool = False, generator: torch.Generator | None = None
    ) -> torch.Tensor:
        x = self.aggregate_features(batch, training, generator)
        return self.transformer_forward(x, batch.get("subject_id"))

    def get_modality_latents(self, batch: Batch, modality: str) -> torch.Tensor:
        return self.contrastive_heads[modality](self._prepare_modality(batch[modality]))

    def _readout(self, latents: torch.Tensor, batch: Batch, pool_outputs: bool) -> torch.Tensor:
        """(B, T, H) brain latents -> (B, O, T') predictions."""
        x = self.predictor(latents.transpose(1, 2), batch.get("subject_id"))  # (B, O, T)
        if pool_outputs:
            mat = self._pool_matrix(x.shape[-1], self.n_output_timesteps, x.device)
            x = x.float() @ mat
        return x.float()

    # -- main entry points ------------------------------------------------
    def forward(
        self,
        batch: Batch,
        training: bool = False,
        pool_outputs: bool = True,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        latents = self.get_brain_latents(batch, training, generator)
        return self._readout(latents, batch, pool_outputs)

    def forward_with_contrastive(
        self,
        batch: Batch,
        training: bool = False,
        pool_outputs: bool = True,
        generator: torch.Generator | None = None,
        gather_rows: tp.Callable[[torch.Tensor], torch.Tensor] | None = None,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Predictions + InfoNCE losses from one shared trunk pass.

        ``gather_rows`` (data parallelism) gathers the rows of the other
        data ranks: InfoNCE takes its negatives over the global batch."""
        cfg = self.config
        latents = self.get_brain_latents(batch, training, generator)
        x = self._readout(latents, batch, pool_outputs)
        losses: dict[str, torch.Tensor] = {}
        if cfg.contrastive_enabled:
            for modality in cfg.contrastive_modalities:
                if modality not in self.contrastive_heads or modality not in batch:
                    continue
                mod = self.get_modality_latents(batch, modality)
                if mod.shape[1] != latents.shape[1]:
                    pmat = self._pool_matrix(mod.shape[1], latents.shape[1], mod.device)
                    mod = torch.einsum("btd,ts->bsd", mod, pmat)
                q, k = latents.float(), mod.float()
                if gather_rows is not None:
                    q, k = gather_rows(q), gather_rows(k)
                losses[modality] = _info_nce(q, k, cfg.contrastive_temperature)
        return x, losses


def _safe_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    # eps inside the sqrt: the gradient is finite for exactly-zero rows
    norm = torch.sqrt(torch.sum(x**2, dim=-1, keepdim=True) + eps)
    return x / norm


def _info_nce(q: torch.Tensor, k: torch.Tensor, tau: float = 0.07) -> torch.Tensor:
    """Symmetric InfoNCE with positives on the diagonal: the mean of
    logsumexp(row) - diag and of logsumexp(col) - diag over one logits product."""
    bt = q.shape[0] * q.shape[1]
    h = q.shape[2]
    q = _safe_normalize(q.reshape(bt, h))
    k = _safe_normalize(k.reshape(bt, h))
    logits = (q @ k.T) / tau
    diag = torch.sum(q * k, dim=-1) / tau
    row = torch.logsumexp(logits, dim=1)
    col = torch.logsumexp(logits, dim=0)
    return 0.5 * ((row - diag).mean() + (col - diag).mean())
