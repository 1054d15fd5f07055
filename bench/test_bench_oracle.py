"""The benchmark's oracle and its frozen copies of the program's prompt,
tokenizer and bucket planner."""
import numpy as np
import pytest

from benchkit import cell as C
from benchkit import data, text
from repro_torch.core.oracle import ModelOracle
from repro_torch.data import HashTokenizer
from repro_torch.serving.batcher import BucketBatcher


@pytest.mark.parametrize("vocab", [512, 65536, 92553])
def test_prompt_ids_equal_model_oracle(smoke, vocab):
    cs = smoke(rows=500, dim=16)
    table = data.Table(cs["mix"], "cpu")
    pred = data.predicate(cs["mix"], 17)
    mo = ModelOracle(None, HashTokenizer(vocab), pred, table.texts)
    for i in range(0, 500, 7):
        assert text.prompt_ids(pred, table.texts[i], vocab) == \
            mo.pack_prompts([i])[0]


@pytest.mark.parametrize("max_batch", [4, 64])
def test_plan_buckets_equal_the_batcher(max_batch):
    rng = np.random.default_rng(0)
    lens = rng.integers(20, 70, 150)
    prompts = [[5] * int(n) for n in lens]
    want = np.zeros(len(lens), np.int64)
    for idx, toks, _ in BucketBatcher(max_batch=max_batch).plan(prompts):
        want[idx] = toks.shape[1]
    np.testing.assert_array_equal(text.plan_buckets(lens, max_batch), want)


def test_every_call_goes_through_the_engine(smoke):
    cell = C.Cell(smoke(rows=2000, dim=32), "cpu")
    cell.build(5)
    p0 = cell.engine.stats["batched_prompts"]
    r = cell.query(0, cell.labels_of(0))
    asked = np.concatenate(r["oracle"].asked)
    assert cell.engine.stats["batched_prompts"] - p0 == r["calls"] == \
        len(asked)
    assert len(np.unique(asked)) == len(asked)
    np.testing.assert_array_equal(r["mask"][asked], r["labels"][asked])
    ids = r["oracle"].asked[0][:8]
    again = cell.engine.first_token_logits(
        r["oracle"].pack_prompts(ids),
        token_ids=r["oracle"].pack_token_ids(len(ids)))
    np.testing.assert_allclose(r["oracle"].logits[0][:8], again, rtol=1e-5,
                               atol=1e-5)
