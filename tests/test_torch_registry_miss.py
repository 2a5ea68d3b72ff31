"""Names that the JAX package registers and the port does not (ROADMAP C1,
repaired): ``config/registry.py`` ``UNPORTED`` lists each with the ROADMAP
item that ports it, and ``Registry.get`` raises ``NotImplementedError``
naming that item, where a name neither package knows keeps its
``KeyError``.

The table is held to both packages' registries, kind by kind, so that it
cannot go stale; each name raises through the routes a user reaches it by:
``--arch`` (``tasks/base.py`` ``build_model``), ``--task`` and
``--criterion``, and a data config's ``bpe_tokenizer`` and
``pre_tokenizer`` (``data/manifests.py``). Every BPE and tokenizer name is
ported, so those two routes are shown with a name taken out of the port's
registry for the test.
"""

import json

import pytest

import chimera_st_tpu.criterions  # noqa: F401 — registration
import chimera_st_tpu.data.encoders  # noqa: F401
import chimera_st_tpu.models  # noqa: F401
import chimera_st_tpu.optim  # noqa: F401
import chimera_st_tpu.scoring  # noqa: F401
import chimera_st_tpu.tasks  # noqa: F401
import chimera_st_tpu_torch.criterions  # noqa: F401
import chimera_st_tpu_torch.data.encoders  # noqa: F401
import chimera_st_tpu_torch.models  # noqa: F401
import chimera_st_tpu_torch.optim  # noqa: F401
import chimera_st_tpu_torch.scoring  # noqa: F401
import chimera_st_tpu_torch.tasks  # noqa: F401
from chimera_st_tpu.config import registry as JR
from chimera_st_tpu_torch.config import registry as R
from chimera_st_tpu_torch.data.manifests import S2TDataConfig, SpeechToTextDataset
from chimera_st_tpu_torch.tasks import setup_task
from chimera_st_tpu_torch.tasks.base import ChimeraTask

# every JAX name is ported: the table is empty and names no item
ITEMS = set()
# the names ROADMAP A14e ported, narrowed for a build on the CPU
A14E_ARCHITECTURES = {
    **dict.fromkeys(("hf_gpt2", "hf_gpt2_large", "hf_gpt2_medium", "hf_gpt2_xl"),
                    {"n_embd": 16, "n_layer": 1, "n_head": 2, "vocab_size": 50}),
    "transformer_lm_pipe": {"embed_dim": 16, "ffn_dim": 32, "layers": 2, "heads": 2,
                            "tgt_vocab_size": 50},
}


@pytest.mark.parametrize("kind", sorted(JR.REGISTRIES))
def test_table_is_the_jax_names_less_the_ports(kind):
    """``UNPORTED[kind]`` is exactly the JAX names the port lacks; each row
    names an item."""
    jax_names = set(JR.REGISTRIES[kind].keys())
    port_names = set(R.get_registry(kind).keys())
    table = R.UNPORTED.get(kind, {})
    assert set(table) == jax_names - port_names
    assert set(table.values()) <= ITEMS


@pytest.mark.parametrize("name", sorted(A14E_ARCHITECTURES))
def test_arch_route_raises_naming_the_item(name):
    """Once a refusal naming A14e: the ``--arch`` route now builds each of
    its names (narrowed here) into the model the JAX package builds."""
    model = ChimeraTask({}).build_model({"arch": name, **A14E_ARCHITECTURES[name]},
                                        device="cpu")
    model_name, _ = JR.ARCHITECTURES.get(name)
    assert type(model).__name__ == {"hf_gpt2": "GPT2LM",
                                    "transformer_lm_pipe": "PipelinedTransformerLM"}[model_name]
    assert R.ARCHITECTURES.get(name)[0] == model_name
    if model_name == "hf_gpt2":
        assert model.cfg.n_positions == 1024 and len(model.h) == 1


@pytest.mark.parametrize("kind, name", [("task", "dummy_lm"),
                                        ("criterion", "simple_classification")])
def test_task_and_criterion_routes_raise_naming_the_item(kind, name, monkeypatch):
    """Every JAX task and criterion is ported, so the two routes are shown
    with a name taken out of the port's registry for the test."""
    monkeypatch.delitem(R.get_registry(kind)._entries, name)
    monkeypatch.setitem(R.UNPORTED, kind, {name: "A14x"})
    with pytest.raises(NotImplementedError, match="ROADMAP A14x"):
        if kind == "task":
            setup_task({"_name": name, "data": "unused"})
        else:
            ChimeraTask({}).build_criterion({"_name": name})


# the names ROADMAP A14d ported (the convolutional and recurrent zoo)
A14D_ARCHITECTURES = (
    "dummy_model", "dynamicconv_iwslt_de_en", "dynamicconv_lm", "fconv", "fconv_iwslt_de_en",
    "fconv_lm", "fconv_lm_dauphin_gbw", "fconv_lm_dauphin_wikitext103", "fconv_self_att",
    "fconv_self_att_wp", "fconv_wmt_en_de", "fconv_wmt_en_fr", "fconv_wmt_en_ro", "lightconv",
    "lightconv_iwslt_de_en", "lightconv_lm", "lightconv_lm_gbw", "lightconv_wmt_en_de",
    "lightconv_wmt_en_de_big", "lightconv_wmt_en_fr_big", "lightconv_wmt_zh_en_big", "lstm",
    "lstm_lm", "lstm_luong_wmt_en_de", "lstm_wiseman_iwslt_de_en", "pytorch_tutorial_rnn",
    "rnn_classifier", "s2t_berard", "s2t_berard_256_3_3", "s2t_berard_512_3_2",
    "s2t_berard_512_5_3", "simple_lstm", "tutorial_simple_lstm")


@pytest.mark.parametrize("name", A14D_ARCHITECTURES)
def test_zoo_architecture_resolves_to_the_jax_preset(name):
    """Each A14d architecture resolves in the port to the JAX package's
    model name and fills the same defaults into a config."""
    model, preset = R.ARCHITECTURES.get(name)
    jax_model, jax_preset = JR.ARCHITECTURES.get(name)
    assert model == jax_model and model in R.MODELS
    cfg = {"src_vocab_size": 11, "dropout": 0.2}
    assert preset(dict(cfg)) == jax_preset(dict(cfg))


@pytest.mark.parametrize("field, kind, name", [("bpe_tokenizer", "bpe", "gpt2"),
                                               ("pre_tokenizer", "tokenizer", "moses")])
def test_data_config_routes_raise_naming_the_item(field, kind, name, tmp_path, monkeypatch):
    """A data config naming an unported BPE or tokenizer raises naming its
    item when its dataset is built; with the name registered it builds."""
    key = "bpe" if kind == "bpe" else "tokenizer"
    extra = {"gpt2_encoder_json": "unused", "gpt2_vocab_bpe": "unused"} if kind == "bpe" else {}
    (tmp_path / "config.yaml").write_text(json.dumps({field: {key: name, **extra}}))
    cfg = S2TDataConfig(str(tmp_path / "config.yaml"))
    registry = R.get_registry(kind)
    monkeypatch.delitem(registry._entries, name)
    monkeypatch.setitem(R.UNPORTED, kind, {name: "A14x"})
    with pytest.raises(NotImplementedError, match="ROADMAP A14x"):
        SpeechToTextDataset("train", True, cfg, [], [])
    monkeypatch.undo()
    if kind == "tokenizer":
        assert SpeechToTextDataset("train", True, cfg, [], []).pre_tokenizer is not None


def test_unknown_names_keep_the_key_error():
    for kind in ("architecture", "task", "bpe", "scoring"):
        with pytest.raises(KeyError, match="unknown"):
            R.get_registry(kind).get("no_such_name")
