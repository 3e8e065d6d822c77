"""The check that decides ``correct``, driven through a whole run of the
harness on tiny cells (f32 on the CPU): the port's engine agrees with the
plain reference; a token altered where it is produced, a dropped LoRA
delta and the control (the reference in a lower precision, put in the
program's place) each come out not correct."""
import pytest
import torch

from benchmark.tests import tiny


CELLS = {"tiny-qwen.chat": "mean_logprob_error",
         "tiny-moe.rag": "mean_logit_gap"}


@pytest.mark.parametrize("cell,seed", [("tiny-qwen.chat", 4000000001),
                                       ("tiny-moe.rag", 5)])
def test_port_agrees_with_reference(run_cell, cell, seed):
    rc, res, err = run_cell(cell, seed=seed)
    assert rc == 0, err
    c = res["compared"]
    assert res["correct"] and c[CELLS[cell]]["value"] <= tiny.LIMIT
    assert list(c) == [CELLS[cell], "engine_errors"]
    assert list(res)[-1] == "compared"
    if cell == "tiny-qwen.chat":
        assert set(res["metrics"]) == {"itl_p99_ms", "setup_s"}


@pytest.mark.parametrize("cell,seed", [("tiny-qwen.chat", 4000000001),
                                       ("tiny-moe.rag", 5)])
def test_control_is_not_correct(run_cell, cell, seed):
    """The configuration's control (fp8 products for the dense model,
    int4 weights for the int8 one) in the program's place."""
    rc, res, err = run_cell(cell, seed=seed, extra=("--control",))
    assert rc == 0, err
    assert res["correct"] is False
    assert res["compared"][CELLS[cell]]["value"] > 3 * tiny.LIMIT


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_altered_token_is_not_correct(run_cell, monkeypatch, cell):
    from llm_instance_gateway_tpu_torch.server import engine as eng
    real = eng.sample

    def wrong(logits, *a, **k):
        return (real(logits, *a, **k) + 1) % logits.shape[-1]
    monkeypatch.setattr(eng, "sample", wrong)
    rc, res, err = run_cell(cell, seed=6)
    assert rc == 0, err
    assert res["correct"] is False
    assert res["compared"][CELLS[cell]]["value"] > tiny.LIMIT


def test_dropped_lora_delta_is_not_correct(run_cell, monkeypatch):
    from llm_instance_gateway_tpu_torch.models import lora
    monkeypatch.setattr(lora, "lora_delta",
                        lambda x, a, b, scale, slot_ids: torch.zeros(
                            *x.shape[:-1], b.shape[-1], dtype=x.dtype))
    rc, res, err = run_cell("tiny-qwen.chat", seed=7)
    assert rc == 0, err
    assert res["correct"] is False


def test_no_card_no_result(root, capsys):
    from benchmark import run
    rc = run.main(["--workload", "tiny-qwen.chat", "--seed", "1",
                   "--seconds", "1", "--trace", "0"], root=root)
    out, _ = capsys.readouterr()
    if not torch.cuda.is_available():
        assert rc == 2 and "{" not in out
