"""The port's HTTP/SSE front door (``serving/server``) and its serving twin
(``serving/serve``) on the CPU.

Ported from the JAX package's ``tests/test_server.py`` case by case (each
docstring names its JAX test), over a real socket on an ephemeral port:
health, a blocking generate, an SSE stream that survives the kill of its
replica, the deadline mapping, 429 with Retry-After, abort and the admin
handles. Then the twin itself: ``python -m
pytorch_distributed_tpu_torch.serving.serve --preset gpt2 --replicas 2
--device cpu --port 0`` through its own ``build`` (the JAX quickstart's
calls), its module entry point in a subprocess, and what it refuses.
"""

import asyncio
import http.client
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from pytorch_distributed_tpu_torch.config import ModelConfig
from pytorch_distributed_tpu_torch.models import gpt2
from pytorch_distributed_tpu_torch.serving import serve
from pytorch_distributed_tpu_torch.serving.chaos import VirtualClock
from pytorch_distributed_tpu_torch.serving.engine import (
    BatchedDecodeEngine,
    PagedBatchedDecodeEngine,
)
from pytorch_distributed_tpu_torch.serving.router import ReplicaRouter
from pytorch_distributed_tpu_torch.serving.server import ServingServer

ENGINE_KW = dict(slots=2, max_len=24, page_size=8, prefill_chunk=8,
                 retry_backoff_s=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """These tests run many tiny forwards, whose cost on a loaded host is
    the intra-op thread pool's synchronisation: one thread for the
    module, restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg():
    return ModelConfig(
        family="gpt2", vocab_size=97, n_ctx=64, n_embd=64, n_layer=2,
        n_head=4, dtype="float32", attn_pdrop=0.0, resid_pdrop=0.0,
        embd_pdrop=0.0,
    )


def _params(cfg):
    return gpt2.init(torch.Generator().manual_seed(0), cfg, device="cpu")


def _setup(cfg, params, *, n_replicas=2, clock=None, **router_kw):
    def make_engine(rep_id):
        kw = {} if clock is None else dict(clock=clock, sleep=clock.sleep)
        return PagedBatchedDecodeEngine(cfg, device="cpu", **ENGINE_KW, **kw)

    if clock is not None:
        router_kw.setdefault("clock", clock)
    router = ReplicaRouter(make_engine, n_replicas, **router_kw)
    router.warmup(params)
    return ServingServer(router, params, default_max_new=4)


async def _http(host, port, method, path, body=None):
    """One request/response over a fresh connection: (status, headers,
    body bytes)."""
    reader, writer = await asyncio.open_connection(host, port)
    payload = b"" if body is None else json.dumps(body).encode()
    writer.write(
        (f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
         f"Content-Length: {len(payload)}\r\n\r\n").encode() + payload
    )
    await writer.drain()
    raw = await asyncio.wait_for(reader.read(), 120)
    writer.close()
    head, _, rest = raw.partition(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        k, _, v = line.partition(":")
        headers[k.strip().lower()] = v.strip()
    return int(lines[0].split()[1]), headers, rest


def _sse_events(raw: bytes):
    out = []
    for block in raw.decode().split("\n\n"):
        event, data = "message", None
        for line in block.strip().split("\n"):
            if line.startswith("event:"):
                event = line[len("event:"):].strip()
            elif line.startswith("data:"):
                data = json.loads(line[len("data:"):].strip())
        if data is not None:
            out.append((event, data))
    return out


def test_server_roundtrip_and_failover_stream():
    """JAX ``test_server_roundtrip_and_failover_stream``: healthz, a
    blocking generate equal to the engine's tokens, an SSE stream whose
    replica is killed mid-flight (it completes token-identically on the
    survivor, every generated token streamed once), and admin restart."""
    cfg = _cfg()
    params = _params(cfg)
    ref_eng = PagedBatchedDecodeEngine(cfg, device="cpu", **ENGINE_KW)
    r0 = ref_eng.submit(np.asarray([1, 2, 3], np.int32), 4)
    r1 = ref_eng.submit(np.asarray([5, 6, 7, 8], np.int32), 8)
    ref_eng.run(params)
    ref_short = [int(t) for t in ref_eng.pop_result(r0).tokens]
    ref_long = [int(t) for t in ref_eng.pop_result(r1).tokens]
    server = _setup(cfg, params)

    async def scenario():
        host, port = await server.start()
        try:
            status, _, body = await _http(host, port, "GET", "/healthz")
            assert status == 200
            health = json.loads(body)
            assert set(health["replicas"]) == {"0", "1"}
            assert health["replicas"]["0"]["state"] == "HEALTHY"

            status, _, body = await _http(
                host, port, "POST", "/v1/generate",
                {"prompt": [1, 2, 3], "max_new_tokens": 4},
            )
            assert status == 200
            res = json.loads(body)
            assert res["state"] == "DONE" and res["tokens"] == ref_short

            reader, writer = await asyncio.open_connection(host, port)
            payload = json.dumps({"prompt": [5, 6, 7, 8],
                                  "max_new_tokens": 8,
                                  "stream": True}).encode()
            writer.write(
                (f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                 f"Content-Length: {len(payload)}\r\n\r\n").encode()
                + payload
            )
            await writer.drain()
            buf = b""
            killed = False
            while True:
                chunk = await asyncio.wait_for(reader.read(4096), 60)
                if not chunk:
                    break
                buf += chunk
                if not killed and b"data:" in buf:
                    killed = True
                    s, _, kb = await _http(host, port, "POST",
                                           "/admin/kill", {"replica": 0})
                    assert s == 200
                    assert json.loads(kb)["states"]["0"] == "DOWN"
            writer.close()
            events = _sse_events(buf)
            done = [d for e, d in events if e == "done"]
            assert len(done) == 1 and done[0]["state"] == "DONE"
            assert done[0]["tokens"] == ref_long
            streamed = [d["token"] for e, d in events if e == "message"]
            assert streamed == ref_long[4:]
            status, _, body = await _http(host, port, "GET", "/healthz")
            assert json.loads(body)["replicas"]["0"]["state"] == "DOWN"

            status, _, body = await _http(
                host, port, "POST", "/admin/restart", {"replica": 0}
            )
            assert status == 200
            assert json.loads(body)["states"]["0"] == "HEALTHY"
        finally:
            await server.stop()

    asyncio.run(scenario())


def test_server_shed_429_deadline_and_abort():
    """JAX ``test_server_shed_429_deadline_and_abort``: overload maps to
    429 + Retry-After; timeout_s maps onto the engine deadline (EXPIRED
    over the wire, the clean partial prefix); abort of an unknown rid is
    404; malformed bodies are 400."""
    cfg = _cfg()
    params = _params(cfg)
    clock = VirtualClock()
    server = _setup(cfg, params, n_replicas=1, shed_queue_depth=1,
                    clock=clock)

    async def scenario():
        host, port = await server.start()
        try:
            probe = asyncio.create_task(_http(
                host, port, "POST", "/v1/generate",
                {"prompt": [7, 7], "max_new_tokens": 16, "timeout_s": 0.04},
            ))
            for _ in range(500):
                _, _, body = await _http(host, port, "GET", "/healthz")
                rep = json.loads(body)["replicas"]["0"]
                if rep["queue_depth"] + rep["active_rows"] >= 1:
                    break
                await asyncio.sleep(0.005)
            clock.advance(1.0)
            status, _, body = await probe
            assert status == 200
            res = json.loads(body)
            assert res["state"] == "EXPIRED"
            assert res["tokens"][:2] == [7, 7]

            blocker = asyncio.create_task(_http(
                host, port, "POST", "/v1/generate",
                {"prompt": [3] * 8, "max_new_tokens": 16},
            ))
            probes = await asyncio.gather(*[
                _http(host, port, "POST", "/v1/generate",
                      {"prompt": [4, 5], "max_new_tokens": 2})
                for _ in range(6)
            ])
            rejected = [(h, json.loads(b)) for s, h, b in probes
                        if s == 429]
            assert rejected, "overload never shed"
            headers, body = rejected[0]
            assert int(headers["retry-after"]) >= 1
            assert body["retry_after_s"] > 0
            await blocker

            status, _, body = await _http(host, port, "POST", "/v1/abort",
                                          {"rid": 10_000})
            assert status == 404
            status, _, _ = await _http(host, port, "POST", "/v1/generate",
                                       {"prompt": []})
            assert status == 400
            status, _, _ = await _http(
                host, port, "POST", "/v1/generate",
                {"prompt": [1], "max_new_tokens": 10_000},
            )
            assert status == 400
        finally:
            await server.stop()

    asyncio.run(scenario())


def test_server_abort_sampling_and_refusals():
    """A request aborted by rid over the wire; a sampled request without a
    seed gets one, and one with a seed is reproducible; ``tenant`` on a
    fleet without adapters is 400 with the reason, as are unknown sessions; unknown
    routes 404, wrong methods 405, bad admin bodies 400."""
    cfg = _cfg()
    params = _params(cfg)
    server = _setup(cfg, params, n_replicas=1)

    async def scenario():
        host, port = await server.start()
        try:
            status, _, body = await _http(
                host, port, "POST", "/v1/generate",
                {"prompt": [3, 4], "max_new_tokens": 5, "temperature": 0.9,
                 "top_k": 20})
            assert status == 200 and json.loads(body)["state"] == "DONE"
            status, _, body = await _http(
                host, port, "POST", "/v1/generate",
                {"prompt": [3, 4], "max_new_tokens": 5, "temperature": 0.9,
                 "seed": 7})
            again = await _http(
                host, port, "POST", "/v1/generate",
                {"prompt": [3, 4], "max_new_tokens": 5, "temperature": 0.9,
                 "seed": 7})
            assert json.loads(body)["tokens"] == json.loads(again[2])[
                "tokens"]
            for body, match in (
                ({"prompt": [1], "tenant": "a"}, "adapter registry"),
                ({"prompt": [1], "session": 5}, "unknown router session"),
                ({"prompt": [1], "session": "x"}, "integer sid"),
                ({"prompt": [1], "priority": "urgent"}, "priority"),
            ):
                status, _, raw = await _http(host, port, "POST",
                                             "/v1/generate", body)
                assert status == 400 and match in json.loads(raw)["error"]
            assert (await _http(host, port, "GET", "/nope"))[0] == 404
            assert (await _http(host, port, "GET", "/v1/generate"))[0] == 405
            assert (await _http(host, port, "POST", "/admin/kill",
                                {}))[0] == 400
            assert (await _http(host, port, "POST", "/admin/explode",
                                {"replica": 0}))[0] == 404

            long = asyncio.create_task(_http(
                host, port, "POST", "/v1/generate",
                {"prompt": [9] * 4, "max_new_tokens": 18}))
            for _ in range(500):
                _, _, body = await _http(host, port, "GET", "/healthz")
                if json.loads(body)["counters"]["routed"] >= 4:
                    break
                await asyncio.sleep(0.005)
            status, _, body = await _http(host, port, "POST", "/v1/abort",
                                          {"rid": 3})
            assert status == 200
            res = json.loads((await long)[2])
            assert res["rid"] == 3
            if json.loads(body)["aborted"]:
                assert res["state"] == "ABORTED"
            else:
                assert res["state"] == "DONE"
        finally:
            await server.stop()

    asyncio.run(scenario())


def _get(host, port, path):
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("GET", path)
    resp = conn.getresponse()
    out = resp.status, dict(resp.getheaders()), json.loads(resp.read())
    conn.close()
    return out


def _post(host, port, path, body):
    conn = http.client.HTTPConnection(host, port, timeout=120)
    conn.request("POST", path, json.dumps(body))
    resp = conn.getresponse()
    out = resp.status, dict(resp.getheaders()), json.loads(resp.read())
    conn.close()
    return out


def test_serving_twin_runs_the_quickstart_on_the_cpu():
    """``serve --preset gpt2 --replicas 2 --device cpu --port 0``, built by
    the twin's own ``build``: /healthz, a plain /v1/generate, an SSE
    stream that survives /admin/kill of its replica, /admin/restart, and
    429 with Retry-After under a burst (``--queue-limit 1``: one queued
    request per replica, so a burst of 24 must overflow whatever the
    host's speed)."""
    args = serve.parse_args(["--preset", "gpt2", "--replicas", "2",
                             "--device", "cpu", "--port", "0",
                             "--max-len", "128", "--queue-limit", "1"])
    cfg, params, router, server = serve.build(args)
    assert (cfg.n_embd, cfg.n_layer, cfg.vocab_size) == (768, 12, 50257)
    with serve.serve_in_thread(server) as (host, port):
        status, _, health = _get(host, port, "/healthz")
        assert status == 200 and set(health["replicas"]) == {"0", "1"}
        status, _, res = _post(host, port, "/v1/generate",
                               {"prompt": [1, 2, 3], "max_new_tokens": 4})
        assert status == 200 and res["state"] == "DONE"
        assert len(res["tokens"]) == 7

        conn = http.client.HTTPConnection(host, port, timeout=120)
        conn.request("POST", "/v1/generate", json.dumps(
            {"prompt": [5, 6, 7, 8], "max_new_tokens": 12, "stream": True}))
        resp = conn.getresponse()
        raw, killed = b"", None
        while True:
            line = resp.fp.readline()
            if not line:
                break
            raw += line
            if killed is None and line.startswith(b"data:"):
                _, _, h = _get(host, port, "/healthz")
                busy = [int(i) for i, r in h["replicas"].items()
                        if r["active_rows"] + r["queue_depth"]]
                killed = busy[0]
                s, _, kb = _post(host, port, "/admin/kill",
                                 {"replica": killed})
                assert s == 200 and kb["states"][str(killed)] == "DOWN"
        conn.close()
        events = _sse_events(raw)
        done = [d for e, d in events if e == "done"]
        streamed = [d["token"] for e, d in events if e == "message"]
        assert len(done) == 1 and done[0]["state"] == "DONE"
        assert len(streamed) == 12 and done[0]["tokens"][4:] == streamed
        _, _, h = _get(host, port, "/healthz")
        assert h["replicas"][str(killed)]["state"] == "DOWN"
        assert h["counters"]["failovers"] == 1
        status, _, body = _post(host, port, "/admin/restart",
                                {"replica": killed})
        assert status == 200 and body["states"][str(killed)] == "HEALTHY"

        with ThreadPoolExecutor(24) as pool:
            burst = list(pool.map(
                lambda _: _post(host, port, "/v1/generate",
                                {"prompt": [2, 3], "max_new_tokens": 6}),
                range(24)))
        shed = [(h, b) for s, h, b in burst if s == 429]
        assert shed, "the burst never met a 429"
        assert all(int(h["Retry-After"]) >= 1 and b["retry_after_s"] > 0
                   for h, b in shed)
        assert all(b["state"] == "DONE" for s, _, b in burst if s == 200)


def test_serving_twin_module_entry_point_starts_and_answers():
    """``python -m pytorch_distributed_tpu_torch.serving.serve`` in a
    subprocess (``--preset tiny --device cpu --port 0``): it logs its
    port, answers /healthz and a generate, and stops on SIGTERM."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "pytorch_distributed_tpu_torch.serving.serve",
         "--preset", "tiny", "--device", "cpu", "--port", "0",
         "--max-len", "64"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    try:
        port = None
        for line in proc.stdout:
            if "serving on http://" in line:
                port = int(line.rsplit(":", 1)[1].split()[0])
                break
        assert port, "the server never logged its port"
        status, _, health = _get("127.0.0.1", port, "/healthz")
        assert status == 200 and len(health["replicas"]) == 2
        status, _, res = _post("127.0.0.1", port, "/v1/generate",
                               {"prompt": [1, 2], "max_new_tokens": 3})
        assert status == 200 and res["state"] == "DONE"
    finally:
        proc.terminate()
        proc.wait(timeout=60)


def test_serving_twin_dense_serves_and_fails_over():
    """``serve --dense``: the twin's ``build`` makes dense
    ``BatchedDecodeEngine`` replicas, and a streamed request survives
    /admin/kill of its replica, DONE with every token."""
    args = serve.parse_args(["--preset", "tiny", "--dense", "--replicas",
                             "2", "--device", "cpu", "--port", "0",
                             "--max-len", "64"])
    assert args.dense is True
    cfg, params, router, server = serve.build(args)
    assert all(type(e) is BatchedDecodeEngine
               for e in router.engines().values())
    with serve.serve_in_thread(server) as (host, port):
        conn = http.client.HTTPConnection(host, port, timeout=120)
        conn.request("POST", "/v1/generate", json.dumps(
            {"prompt": [5, 6, 7, 8], "max_new_tokens": 12, "stream": True}))
        resp = conn.getresponse()
        raw, killed = b"", None
        while True:
            line = resp.fp.readline()
            if not line:
                break
            raw += line
            if killed is None and line.startswith(b"data:"):
                _, _, h = _get(host, port, "/healthz")
                killed = next(int(i) for i, r in h["replicas"].items()
                              if r["active_rows"] + r["queue_depth"])
                s, _, _ = _post(host, port, "/admin/kill",
                                {"replica": killed})
                assert s == 200
        conn.close()
        events = _sse_events(raw)
        done = [d for e, d in events if e == "done"]
        assert len(done) == 1 and done[0]["state"] == "DONE"
        assert len([d for e, d in events if e == "message"]) == 12
        _, _, h = _get(host, port, "/healthz")
        assert h["replicas"][str(killed)]["state"] == "DOWN"
        assert h["counters"]["failovers"] == 1


@pytest.mark.parametrize("argv, match", [
    (["--tenants", "2", "--lora-rank", "0"], "LoRA"),
    (["--cpu-devices", "8"], "--device cpu"),
])
def test_serving_twin_refuses_what_the_port_lacks(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve.parse_args(argv)


def test_serving_twin_downloads_nothing(tmp_path):
    args = serve.parse_args(["--hf", "gpt2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="downloads nothing"):
        serve.load_params(args)


def test_serving_twin_loads_a_port_checkpoint(tmp_path):
    """``--checkpoint``: the port's npz checkpoint (the format both
    packages write) is what the fleet serves."""
    from pytorch_distributed_tpu_torch.config import TrainConfig
    from pytorch_distributed_tpu_torch.train.checkpoint import (
        save_checkpoint,
    )
    from pytorch_distributed_tpu_torch.train.optim import make_optimizer
    from pytorch_distributed_tpu_torch.train.state import init_train_state

    args = serve.parse_args(["--preset", "tiny", "--device", "cpu",
                             "--max-len", "64", "--seed", "3"])
    cfg, fresh = serve.load_params(args)
    trained = gpt2.init(torch.Generator().manual_seed(99), cfg,
                        device="cpu")
    tx = make_optimizer(TrainConfig(global_batch_size=1,
                                    micro_batch_size=1, num_steps=1))
    save_checkpoint(tmp_path / "ckpt", init_train_state(trained, tx), cfg)
    args.checkpoint = str(tmp_path / "ckpt")
    _, loaded = serve.load_params(args)
    torch.testing.assert_close(loaded["wte"], trained["wte"])
    assert not torch.equal(loaded["wte"], fresh["wte"])
