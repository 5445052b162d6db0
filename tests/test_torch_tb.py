"""The port's TensorBoard scalars (`train/metrics.py`, written with no
package) against the file tapnet_tpu's logger writes through
`flax.metrics.tensorboard`.

- CRC-32C's check value and the TFRecord mask;
- the port's file read back (`read_scalars`, both CRCs checked) gives the
  (tag, step, value as float32) triples of the JSONL records;
- `train(tb_dir=...)` writes a non-empty events file (the JAX test's
  assertion, tests/test_aux.py), on rank 0 only;
- slow (it imports tensorflow): tensorflow's own reader decodes the JAX
  logger's file and the port's, written for the same metrics, to the same
  record structure and the same triples for every tag but `wall`.
"""

import glob
import json

import numpy as np
import pytest
import torch

import tapnet_torch
from tapnet_torch.parallel.mesh import DataMesh
from tapnet_torch.train import metrics as M
from tapnet_torch.train import trainer as T

LOGS = [(1, {"reward": 2.5, "n": 7}, {"event": "resumed"}),
        (2, {"reward": 2.6, "loss": torch.tensor(-0.125)}, {}),
        (0, {"big": 3e38, "tiny": 1e-46, "flag": True}, {}),
        (300, {"reward": 1 / 3}, {})]


def _write(logger_cls, tmp_path, name):
    lg = logger_cls(str(tmp_path / f"{name}.jsonl"), echo=False,
                    tb_dir=str(tmp_path / name))
    for step, metrics, extra in LOGS:
        lg.log(step, metrics, **extra)
    lg.close()
    (path,) = glob.glob(str(tmp_path / name / "events.out.tfevents.*"))
    recs = [json.loads(line) for line in open(tmp_path / f"{name}.jsonl")]
    return path, recs


def _triples(recs):
    return [(k, r["step"], float(np.float32(v))) for r in recs
            for k, v in r.items()
            if k != "step" and isinstance(v, (int, float))]


def test_crc32c():
    assert M.crc32c(b"123456789") == 0xE3069283
    assert M.crc32c(b"") == 0
    # the length header of a 62-byte record, as TensorFlow masks it
    assert M.masked_crc32c((62).to_bytes(8, "little")) == 0xE740D2D9


def test_events_read_back_to_the_jsonl(tmp_path):
    path, recs = _write(M.MetricsLogger, tmp_path, "tb")
    assert path.endswith(".v2")
    got = M.read_scalars(path)
    assert got == _triples(recs)
    assert ("big", 0, float(np.float32(3e38))) in got
    assert ("flag", 0, 1.0) in got and ("tiny", 0, 0.0) in got
    # the file-version event first, then one event per value
    assert len(M.read_events(path)) == 1 + len(got)
    data = bytearray(open(path, "rb").read())
    data[-1] ^= 1
    open(path, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="bad CRC"):
        M.read_scalars(path)


def test_train_writes_events_on_rank_0_only(tmp_path, monkeypatch):
    cfg = tapnet_torch.CONFIGS["2d-basic"]
    loop = T.TrainLoopConfig(epochs=1, steps_per_epoch=2, batch=8,
                             valid_batch=8, hidden=32,
                             metrics_path=str(tmp_path / "m.jsonl"),
                             tb_dir=str(tmp_path / "tb"))
    T.train(cfg, loop, device="cpu")
    events = glob.glob(str(tmp_path / "tb" / "events.out.tfevents.*"))
    assert events and open(events[0], "rb").read()
    recs = [json.loads(line) for line in open(tmp_path / "m.jsonl")]
    assert M.read_scalars(events[0]) == _triples(recs)

    class Stop(Exception):
        pass

    seen = []

    def logger(path, echo, tb_dir):
        seen.append(tb_dir)
        raise Stop

    monkeypatch.setattr(T, "MetricsLogger", logger)
    for rank in (0, 1):
        with pytest.raises(Stop):
            T.train(cfg, loop, device="cpu", mesh=DataMesh(
                None, 2, rank, torch.device("cpu")))
    assert seen == [loop.tb_dir, None]


@pytest.mark.slow  # imports tensorflow (~7 s), as tests/test_aux.py's does
def test_matches_the_jax_logger_file(tmp_path):
    import tensorflow as tf
    from tapnet_tpu.train.metrics import MetricsLogger as JaxLogger

    def decode(path):
        out = []
        for ev in tf.compat.v1.train.summary_iterator(path):
            what = ev.WhichOneof("what")
            vals = []
            for v in ev.summary.value:
                t = v.tensor
                vals.append((v.tag, v.WhichOneof("value"), t.dtype,
                             tuple(d.size for d in t.tensor_shape.dim),
                             v.metadata.plugin_data.plugin_name,
                             float(tf.make_ndarray(t))))
            out.append((what, ev.step, ev.file_version, vals,
                        ev.source_metadata.writer != ""))
        return out

    port, precs = _write(M.MetricsLogger, tmp_path, "port")
    jax_, jrecs = _write(JaxLogger, tmp_path, "jax")
    got, want = decode(port), decode(jax_)
    assert len(got) == len(want) == 1 + len(_triples(precs))
    for g, w in zip(got, want):
        assert g[:3] == w[:3] and g[4] == w[4]
        assert len(g[3]) == len(w[3]) == (0 if g[0] == "file_version" else 1)
        for gv, wv in zip(g[3], w[3]):
            assert gv[:5] == wv[:5]
            if gv[0] != "wall":
                assert gv[5] == wv[5] or (np.isnan(gv[5]) and np.isnan(wv[5]))
    strip = lambda t: [x for x in t if x[0] != "wall"]
    assert strip(M.read_scalars(port)) == strip(M.read_scalars(jax_)) \
        == strip(_triples(jrecs))
