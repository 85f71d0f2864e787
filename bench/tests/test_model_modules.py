"""CPU tests of what a configuration hands the program and the check: its
model keys, each a field of the program's configuration or refused; its
own model module (``reference/<name>.py``: leaves, FLOPs, forward) found
by name; and the three configurations' leaves, FLOPs and program
configuration as pinned."""

import copy
import dataclasses
import hashlib
import json
import pathlib
import re

import pytest

import tiny
from bench import harness, reference, work
from bench.reference import model as ref

ROOT = pathlib.Path(__file__).resolve().parents[2]


# ---------------------------------------------------------------------------
# model keys: passed to the program by name, or refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("where,key,value", [
    ("model", "no_such_key", 1),
    ("moe", "no_such_key", 1),
    ("mla", "no_such_key", 1),
    ("model", "remat", False),            # the harness's own setting
    ("model", "attn_q_chunk", 256),       # the program's own switches
    ("model", "moe_impl", "shard_map"),
    ("moe", "expert_split", 1),           # the program splits 8 experts in 2
])
def test_a_model_key_the_program_lacks_is_refused(where, key, value):
    m = copy.deepcopy(tiny.MLA_MOE)
    (m if where == "model" else m[where])[key] = value
    with pytest.raises(ValueError, match=key):
        harness.port_config(m, "t", train=False)


def test_every_model_key_reaches_the_program():
    m = copy.deepcopy(tiny.MLA_MOE)
    m.update(norm_eps=1e-3, rope_theta=500)
    m["moe"]["router_aux_weight"] = 0.05
    pc = harness.port_config(m, "t", train=True)
    assert pc.norm_eps == 1e-3 and pc.remat and pc.arch_id == "t"
    assert pc.rope_theta == 500.0 and isinstance(pc.rope_theta, float)
    assert pc.moe.router_aux_weight == 0.05 and pc.moe.n_shared == 1
    assert pc.mla.kv_lora_rank == 32 and pc.mlp_kind == "swiglu"


@pytest.mark.parametrize("key,published,model", [
    ("scoring_func", "sigmoid", ("moe", "scoring_func", "softmax")),
    ("n_group", 8, ("moe", "n_group", 1)),
    ("norm_topk_prob", True, ("moe", "norm_topk_prob", False)),
    ("q_lora_rank", 1536, ("mla", "q_lora_rank", 64)),
    ("rope_scaling", {"type": "yarn", "factor": 40},
     ("rope_scaling", None, {"type": "yarn", "factor": 4})),
])
def test_a_published_key_is_checked_where_the_model_states_it(key, published,
                                                              model):
    m = copy.deepcopy(tiny.MLA_MOE)
    harness.model_of({key: published, "model": m})     # not stated: passes
    node, sub, value = model
    if sub is None:
        m[node] = value
    else:
        m[node][sub] = value
    with pytest.raises(ValueError, match=key):
        harness.model_of({key: published, "model": m})
    if sub is None:
        m[node] = published
    else:
        m[node][sub] = published
    assert harness.model_of({key: published, "model": m}) is m


# ---------------------------------------------------------------------------
# a configuration that brings its own model module
# ---------------------------------------------------------------------------

def test_no_reference_imports_the_program():
    # what judges the program imports none of it, nor JAX, nor the
    # benchmark's code that does
    for path in sorted((ROOT / "bench" / "reference").glob("*.py")) + [
            ROOT / "bench" / "weights.py"]:
        assert reference.foreign_imports(path.read_text()) == [], path


@pytest.mark.parametrize("line,name", [
    ("from repro_torch.models import lm", "repro_torch.models"),
    ("import repro_torch.models.moe as moe", "repro_torch.models.moe"),
    ("from bench import harness", "bench.harness"),
    ("import jax.numpy as jnp", "jax.numpy"),
])
def test_a_model_module_that_imports_the_program_is_refused(tmp_path, line,
                                                            name):
    (tmp_path / "reference").mkdir()
    module = "from bench.reference.model import *\n" + line + "\n"
    (tmp_path / "reference" / "mine.py").write_text(module)
    with pytest.raises(ValueError, match=re.escape(f"['{name}']")):
        reference.load(tmp_path, "mine")

GELU = {"family": "dense", "n_layers": 2, "d_model": 64, "n_heads": 4,
        "n_kv_heads": 2, "head_dim": 16, "d_ff": 96, "vocab_size": 256,
        "rope_theta": 10000, "norm_eps": 1e-05, "swa_window": 0,
        "compute_dtype": "float32", "mlp_kind": "gelu"}

# a dense block whose MLP is an ungated GELU (tanh), as granite's: no w3,
# which the default module would draw and the program does not hold
GELU_MODULE = '''
import torch
import torch.nn.functional as F

from bench.reference import model as base
from bench.reference.common import layer_list, rms_norm


def block_leaves(m, moe_layer):
    return [leaf for leaf in base.block_leaves(m, moe_layer)
            if leaf[0] != ("mlp", "w3")]


def layer_matmul_params(m, moe_layer):
    return base.layer_matmul_params(m, moe_layer) - m["d_model"] * m["d_ff"]


def _normed(m, top, layer, tok, prec):
    pos = torch.arange(tok.shape[1], device=tok.device)
    h = top["embed"][tok]
    for stack, i, _ in layer_list(m):
        p = layer(stack, i)
        h = h + base.attention(m, p["attn"],
                               rms_norm(h, p["ln1"], m["norm_eps"]), pos, prec)
        x = rms_norm(h, p["ln2"], m["norm_eps"])
        up = F.gelu(prec.mm(x, p["mlp"]["w1"]), approximate="tanh")
        h = h + prec.mm(up, p["mlp"]["w2"])
    return rms_norm(h, top["final_norm"], m["norm_eps"])


@torch.no_grad()
def serve_logits(m, layer_weights, top_weights, units, prec, device):
    out = []
    for u in units:
        tok = torch.as_tensor(u["tokens"], device=device).long()
        x = _normed(m, top_weights, layer_weights, tok, prec)
        out.append(prec.mm(x[:, u["score"]], top_weights["head"]))
    return out


def loss(m, params, tokens, labels, prec, remat=True):
    x = _normed(m, params, lambda s, i: params[(s, i)], tokens.long(), prec)
    logits = prec.mm(x, params["head"])
    return (torch.logsumexp(logits, -1) - logits.gather(
        -1, labels.long()[..., None])[..., 0]).mean()
'''


def _with_gelu_cell(tmp_path, reference):
    """The tiny benchmark plus a cell ``gelu-serve`` of the GELU model,
    whose configuration names ``reference`` (or no module, if None)."""
    spec_path = tiny.write(tmp_path)
    data = tmp_path / "tinybench"
    (data / "reference").mkdir()
    (data / "reference" / "tiny-gelu.py").write_text(GELU_MODULE)
    cfg = {"model": GELU}
    if reference:
        cfg["reference"] = reference
    (data / "configs" / "tiny-gelu.json").write_text(json.dumps(cfg))
    (data / "limits" / "gelu-serve.json").write_text(json.dumps(
        tiny.SERVE_LIMITS))
    spec = json.loads(spec_path.read_text())
    spec["configs"].append({"name": "tiny-gelu", "source": "t",
                            "reduced": [], "why": "t",
                            "file": "tinybench/configs/tiny-gelu.json"})
    spec["workloads"].append({"name": "gelu-serve", "config": "tiny-gelu",
                              "traffic": "serve", "chips": 1, "why": "t"})
    for e in spec["end_to_end"] + spec["per_layer"]:
        if "decode_tokens_per_s" in (e["name"], e.get("moves")):
            e["workloads"].append("gelu-serve")
    spec_path.write_text(json.dumps(spec))
    return spec_path, data


def test_a_configuration_brings_its_own_model_module(tmp_path):
    before = tiny.harness_digest()
    spec_path, data = _with_gelu_cell(tmp_path, "tiny-gelu")
    cell = harness.Cell(spec_path, "gelu-serve", data)
    # its leaves: the program's dense GELU block, w1 and w2 and no w3
    names = {leaf.name for leaf in cell.leaves}
    assert {"layers.mlp.w1", "layers.mlp.w2"} <= names
    assert "layers.mlp.w3" not in names
    # its FLOPs: a layer's 2*64*64 + 2*64*32 attention and 2*64*96 MLP
    # parameters; 12 tokens, 78 pairs, the head at one row
    params = 2 * (2 * 64 * 64 + 2 * 64 * 32 + 2 * 64 * 96)
    want = 2 * 12 * params + 2 * 2 * 4 * 32 * 78 + 2 * 64 * 256
    assert cell.work.prefill_flops(cell.m, 1, 12) == want
    assert work.prefill_flops(ref, GELU, 1, 12) != want
    # its forward decides `correct`: the default one could not run
    # without w3, and the served tokens lie at the reference's best
    out = harness.run_cell(spec_path, "gelu-serve", 5, 0.2, True,
                           device="cpu", data_root=data)
    assert out["correct"]
    assert out["checks"]["logit_gap_max"]["value"] < 0.05
    assert out["metrics"]["decode_mfu"]["value"] > 0
    assert tiny.harness_digest() == before


def test_a_model_module_the_program_disagrees_with_is_refused(tmp_path):
    # the default module lays out a gated MLP the program does not hold
    spec_path, data = _with_gelu_cell(tmp_path, None)
    with pytest.raises(ValueError, match="w3"):
        harness.run_cell(spec_path, "gelu-serve", 5, 0.2, False,
                         device="cpu", data_root=data)
    # a name that is not a file of reference/ is refused
    cfg = data / "configs" / "tiny-gelu.json"
    cfg.write_text(json.dumps({"model": GELU, "reference": "no-such"}))
    with pytest.raises(FileNotFoundError, match="no-such"):
        harness.Cell(spec_path, "gelu-serve", data)


# ---------------------------------------------------------------------------
# the accepted configurations: leaves and FLOPs as the parent counted them
# ---------------------------------------------------------------------------

# sha256 of the program's configuration (``dataclasses.asdict`` as JSON,
# over the fields below) served and trained, as ``port_config`` built it
# when the configurations were accepted
PINNED_CONFIG = {
    "deepseek-v2-lite-16b": (
        "54e43332054a7a492d2350c2823fbb62c59613eacfffb38ed1203ea303901079",
        "26b36a2daea81aa8c2e0feadd73667044f60ba741501846045047098408deea6"),
    "deepseek-v2-lite-16b-train5": (
        "7a88381a65441552e4c92dd491bf1403422c23ad549c983e0a673c6f63e14611",
        "b5456bffbd029ee24b682367e412035564663bda8c0126881b26fd43410bddf0"),
    "mixtral-8x22b": (
        "93f1245763ec82d009275996b2ac213a95a814a2f9c2a1f059cefb494fe72918",
        "e37cf51d536e04b94af9fbc655bcc1e3aa18f8fcf56699be3fe018b0f548f3cf"),
}

# the fields of the program's configuration classes when the digests were
# pinned; a field added since must hold its declared default in every
# accepted configuration, so a new model's field leaves them as they ran
PINNED_FIELDS = {
    "ModelConfig": (
        "arch_id", "family", "n_layers", "d_model", "n_heads", "n_kv_heads",
        "d_ff", "vocab_size", "head_dim", "rope_theta", "swa_window",
        "tie_embeddings", "norm_eps", "mlp_kind", "moe", "mla", "ssm",
        "attn_every", "shared_attn", "n_codebooks", "mrope_sections",
        "param_dtype", "compute_dtype", "remat", "scan_layers",
        "attn_q_chunk", "attn_schedule", "microbatches", "use_pallas",
        "bf16_stacked_params", "sp_norm", "ssm_chunk", "ssm_bf16",
        "moe_impl", "moe_fsdp_out", "grad_compression"),
    "MoEConfig": (
        "n_experts", "n_shared", "top_k", "d_ff_expert", "first_k_dense",
        "capacity_factor", "router_aux_weight"),
    "MLAConfig": (
        "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
        "v_head_dim"),
}


def _pinned_view(obj, path, moved):
    """``obj`` as ``dataclasses.asdict`` gives it, with only the pinned
    fields of each configuration class; every other field, at any depth,
    whose value is not its declared default is named in ``moved``."""
    if not dataclasses.is_dataclass(obj):
        return copy.deepcopy(obj)
    pinned = PINNED_FIELDS[type(obj).__name__]
    view = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if f.name in pinned:
            view[f.name] = _pinned_view(v, path + (f.name,), moved)
            continue
        default = f.default if f.default_factory is dataclasses.MISSING \
            else f.default_factory()
        if default is dataclasses.MISSING or v != default:
            moved.append(".".join(path + (f.name,)))
    return view


def config_pin(cfg):
    """(the sha256 of the pinned fields, the other fields away from their
    defaults)."""
    moved = []
    view = _pinned_view(cfg, (), moved)
    return (hashlib.sha256(json.dumps(view, sort_keys=True).encode())
            .hexdigest(), moved)


def _accepted_config(config, train):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"] if c["name"] == config)
    m = harness.model_of(json.loads((ROOT / entry["file"]).read_text()))
    return harness.port_config(m, config, train)


@pytest.mark.parametrize("config", sorted(PINNED_CONFIG))
def test_the_accepted_configurations_keep_their_program_config(config):
    got = tuple(config_pin(_accepted_config(config, train))
                for train in (False, True))
    assert got == tuple((d, []) for d in PINNED_CONFIG[config])


def _with_new_moe_field(cfg, **value):
    """``cfg`` whose ``MoEConfig`` has a field more, ``n_routed`` (default
    0), as a later model's field would be added."""
    from repro_torch.configs.base import MoEConfig
    cls = dataclasses.make_dataclass(
        "MoEConfig", [("n_routed", int, dataclasses.field(default=0))],
        bases=(MoEConfig,), frozen=True)
    return dataclasses.replace(cfg, moe=cls(**dataclasses.asdict(cfg.moe),
                                            **value))


def test_a_new_field_at_its_default_keeps_the_pin():
    config = "deepseek-v2-lite-16b"
    cfg = _with_new_moe_field(_accepted_config(config, False))
    assert cfg.moe.n_routed == 0
    assert hashlib.sha256(json.dumps(dataclasses.asdict(cfg), sort_keys=True)
                          .encode()).hexdigest() != PINNED_CONFIG[config][0]
    assert config_pin(cfg) == (PINNED_CONFIG[config][0], [])


def test_a_new_field_away_from_its_default_fails_the_pin():
    config = "deepseek-v2-lite-16b"
    cfg = _with_new_moe_field(_accepted_config(config, False), n_routed=8)
    assert config_pin(cfg) == (PINNED_CONFIG[config][0], ["moe.n_routed"])


@pytest.mark.parametrize("change", [
    {"norm_eps": 1e-3}, {"moe": {"top_k": 5}}, {"mla": {"kv_lora_rank": 256}},
])
def test_an_accepted_configuration_changed_fails_the_pin(change):
    config = "deepseek-v2-lite-16b-train5"
    cfg = _accepted_config(config, True)
    kw = {k: dataclasses.replace(getattr(cfg, k), **v)
          if isinstance(v, dict) else v for k, v in change.items()}
    digest, moved = config_pin(dataclasses.replace(cfg, **kw))
    assert digest != PINNED_CONFIG[config][1] and moved == []


# (leaves, sha256 of [[name, shape, layers, ones, fp32], ...], prefill
# 1 x 8192, decode 32 at position 575, train 2 x 4096, generate 16 x 500
# with 128 new)
PINNED = {
    "deepseek-v2-lite-16b": (
        29, "46d1f8c75dba15b0b695a99488d997e51eaeffd97ab8dba68af2a0c85dea441e",
        46004946599936, 161979826176, 134405808979968, 46705247584256),
    "deepseek-v2-lite-16b-train5": (
        29, "4286b5c0b4d9b2063847080a537c4775de98ffccd437f2e1707679abec6f8933",
        8491779489792, 40823160832, 33205021310976, 9314755346432),
    "mixtral-8x22b": (
        13, "2ca936c7b23de23d0e7e2f6dcd5c302b136c29fffcef48324eb5520be7d0a61c",
        145971442876416, 549860671488, 432965318344704, 168391395508224),
}


@pytest.mark.parametrize("config", sorted(PINNED))
def test_the_accepted_configurations_keep_their_leaves_and_flops(config):
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w["name"] for w in spec["workloads"]
                if w["config"] == config)
    c = harness.Cell(ROOT / "BENCHMARK.json", cell)
    leaves = [[leaf.name, list(leaf.shape), leaf.layers, leaf.ones,
               leaf.fp32] for leaf in c.leaves]
    digest = hashlib.sha256(json.dumps(leaves).encode()).hexdigest()
    w, m = c.work, c.m
    assert (len(leaves), digest, w.prefill_flops(m, 1, 8192),
            w.decode_flops(m, 32, 575), w.train_step_flops(m, 2, 4096),
            w.generate_flops(m, 16, 500, 128)) == PINNED[config], leaves
