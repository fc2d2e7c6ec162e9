"""The configurations the CPU tests hold the references and the yardstick
at: a cell's file under ``bench/configs/``, or, for a family no cell runs
yet (the hybrid), the port's registry entry in the same keys."""
import copy
import json

from bench.harness import ROOT

KEYS = ("family", "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
        "d_ff", "vocab_size", "ssm_state", "ssm_headdim", "ssm_expand",
        "ssm_conv", "ssm_ngroups", "ssm_chunk", "attn_every", "rope_theta",
        "norm_eps", "mlp_act", "tie_embeddings", "dtype", "param_dtype")


def source(name: str) -> dict:
    """``{"registry_id": ..., "model": {...}}`` of ``name`` at full size."""
    path = ROOT / "bench" / "configs" / f"{name}.json"
    if path.is_file():
        return json.loads(path.read_text())
    from repro_torch.configs import get_config
    cfg = get_config(name)
    return {"registry_id": name,
            "model": {k: getattr(cfg, k) for k in KEYS}}


def smoke(name: str, sizes: dict, dtype: str = None) -> dict:
    """``source(name)`` with ``sizes`` (and ``dtype``) in its model."""
    c = copy.deepcopy(source(name))
    c["model"].update(sizes)
    if dtype is not None:
        c["model"].update(dtype=dtype, param_dtype=dtype)
    return c
