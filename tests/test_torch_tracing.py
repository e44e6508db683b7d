"""The port's span recorder (``utils/profiling``: ``span``, ``spans``,
``recording``) and the span tree of the two served paths.

Off, a span records nothing and still fills the timings dict it is given;
on (inside ``recording()`` or a ``torch.profiler`` session), it records the
span open around it, threads and tasks apart, in a bounded deque, on the
clock the profiler's ``record_function`` ranges map onto. A miner request
and an audit on the CPU emit the tree the benchmark's readers and the
Chrome trace read, and the roles' timing dicts keep their keys.
"""

import asyncio
import collections
import threading
import time

import numpy as np
import pytest
import torch

from dvdx_tpu_torch.network.mock import build_mock_network
from dvdx_tpu_torch.network.validator import ValidatorConfig
from dvdx_tpu_torch.pipelines.text2video import build_pipeline
from dvdx_tpu_torch.utils import profiling
from dvdx_tpu_torch.utils.profiling import recording, span, spans
from dvdx_tpu_torch.utils.testing import perturb_zero_params

STEPS, FRAMES = 4, 4
MINER_TIMINGS = {"generate", "gen_dispatch_loop", "gen_compute_wall", "gen_leaf_fetch",
                 "gen_video_fetch", "merkle_commit", "encode_mp4"}
AUDIT_TIMINGS = {"reveal_roundtrip", "merkle_verify", "base_noise", "reexecution",
                 "video_binding"}
VERIFY_TIMINGS = AUDIT_TIMINGS | {"video_decode", "authenticity", "mdvqs_score"}


def last_id() -> int:
    # spans are kept in the order they end, ids in the order they start
    return max((s.id for s in spans()), default=0)


def new_spans(since: int):
    return [s for s in spans() if s.id > since]


def children(recorded):
    kids = collections.defaultdict(list)
    for s in recorded:
        kids[s.parent].append(s)
    for v in kids.values():
        v.sort(key=lambda s: s.start_ns)
    return kids


def names(kids, parent):
    return [s.name for s in kids[parent.id]]


def under(kids, root):
    """``root`` and every span below it."""
    out, todo = [], [root]
    while todo:
        s = todo.pop()
        out.append(s)
        todo += kids[s.id]
    return out


def test_off_records_nothing_and_still_fills_timings():
    since = last_id()
    timings = {}
    with span("phase") as s:
        assert s is None
    with span("dispatch_loop", timings) as timed:
        time.sleep(0.002)
    with span("wait.compute", timings, key="compute_wall"):
        pass
    with span("merkle_verify", timings, accumulate=True):
        time.sleep(0.001)
    with span("merkle_verify", timings, accumulate=True):
        time.sleep(0.001)
    with pytest.raises(ValueError):
        with span("failing", timings):
            raise ValueError("a phase that fails records no seconds")
    assert new_spans(since) == []
    assert list(timings) == ["dispatch_loop", "compute_wall", "merkle_verify"]
    assert timings["dispatch_loop"] == round(timed.seconds, 4) >= 0.002
    assert timings["merkle_verify"] >= 0.002
    # an off span without timings is one shared object
    assert span("a") is span("b")


def test_on_records_nesting_and_parents():
    since = last_id()
    timings = {}
    with recording():
        with span("root"):
            with span("child", timings):
                with span("wait.fetch"):
                    pass
            with span("other"):
                pass
    got = {s.name: s for s in new_spans(since)}
    assert set(got) == {"root", "child", "wait.fetch", "other"}
    root = got["root"]
    assert root.parent == 0
    assert got["child"].parent == got["other"].parent == root.id
    assert got["wait.fetch"].parent == got["child"].id
    for s in got.values():
        assert s.start_ns <= s.end_ns
    assert root.start_ns <= got["child"].start_ns <= got["child"].end_ns <= root.end_ns
    assert timings["child"] == round((got["child"].end_ns - got["child"].start_ns) / 1e9, 4)
    # the stack unwinds: a span after the block is a root again
    with recording():
        with span("after"):
            pass
    assert spans()[-1].parent == 0


def test_threads_and_tasks_stay_apart():
    since = last_id()
    barrier = threading.Barrier(4)

    def serve():
        with span("request"):
            barrier.wait(timeout=30)
            for i in range(20):
                with span("step"):
                    with span("inner"):
                        pass

    async def audits():
        async def one():
            async with span("audit"):
                for _ in range(5):
                    with span("phase"):
                        await asyncio.sleep(0)
        await asyncio.gather(one(), one())

    with recording():
        threads = [threading.Thread(target=serve) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        asyncio.new_event_loop().run_until_complete(audits())
    got = new_spans(since)
    by_id = {s.id: s for s in got}
    kids = children(got)
    roots = [s for s in got if s.parent == 0]
    assert sorted(s.name for s in roots) == ["audit"] * 2 + ["request"] * 4
    for root in roots:
        want = {"request": ["step"] * 20, "audit": ["phase"] * 5}[root.name]
        assert names(kids, root) == want
    for s in got:
        if s.parent:
            parent = by_id[s.parent]
            assert parent.start_ns <= s.start_ns and s.end_ns <= parent.end_ns
            want = {"step": "request", "inner": "step", "phase": "audit"}[s.name]
            assert parent.name == want
    assert collections.Counter(s.name for s in got) == {
        "request": 4, "step": 80, "inner": 80, "audit": 2, "phase": 10}


def test_the_record_is_bounded():
    with recording():
        for i in range(profiling.MAX_SPANS + 10):
            with span(f"bounded{i}"):
                pass
    got = spans()
    assert len(got) == profiling.MAX_SPANS
    assert got[-1].name == f"bounded{profiling.MAX_SPANS + 9}"
    assert got[0].name == "bounded10"


def test_recording_follows_a_torch_profiler_session():
    since = last_id()
    with span("before"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("inside"):
            torch.ones(4).sum()
    with span("after"):
        pass
    assert [s.name for s in new_spans(since)] == ["inside"]


def test_spans_share_the_clock_of_record_function_ranges():
    """Each span's edges against its ``record_function`` range from the
    profiler's raw events, mapped onto ``perf_counter`` by one pair of
    readings as the benchmark's trace reader maps the card's events."""
    since = last_id()
    x = torch.randn(128, 128)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span("clock_outer"):
            for i in range(5):
                with span(f"clock_inner{i}"):
                    for _ in range(20):
                        x = torch.tanh(x @ x)
    wall0, perf0 = time.time_ns(), time.perf_counter()
    ranges = {e.name(): (perf0 + (e.start_ns() - wall0) / 1e9, perf0 + (e.end_ns() - wall0) / 1e9)
              for e in prof.profiler.kineto_results.events() if e.name().startswith("clock_")}
    got = new_spans(since)
    assert len(got) == 6 and set(ranges) == {s.name for s in got}
    for s in got:
        start, end = ranges[s.name]
        assert abs(start - s.start_ns / 1e9) < 2e-4, s.name
        assert abs(end - s.end_ns / 1e9) < 2e-4, s.name


def test_a_span_across_awaits_is_recorded_but_is_no_range():
    """Tasks that share a thread would open and close their ranges out of
    order, so an ``async with`` span enters no ``record_function``; the
    spans inside it, with no ``await`` of their own, still do."""
    since = last_id()

    async def one(i):
        async with span(f"await_root{i}"):
            with span(f"await_inner{i}"):
                pass
            await asyncio.sleep(0)

    async def both():
        await asyncio.gather(one(0), one(1))

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        asyncio.new_event_loop().run_until_complete(both())
    ranged = {e.name() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("await_")}
    got = {s.name: s for s in new_spans(since)}
    assert set(got) == {"await_root0", "await_root1", "await_inner0", "await_inner1"}
    assert got["await_inner0"].parent == got["await_root0"].id
    assert ranged == {"await_inner0", "await_inner1"}
    # off, the shared span is an async context manager too
    timings = {}

    async def off():
        async with span("off_root"):
            async with span("off_timed", timings):
                await asyncio.sleep(0)

    asyncio.new_event_loop().run_until_complete(off())
    assert list(timings) == ["off_timed"]


def test_no_span_synchronises_or_records_a_device_event(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a span touched the card")

    for name in ("synchronize", "Event", "current_stream", "set_sync_debug_mode"):
        monkeypatch.setattr(torch.cuda, name, refuse)
    monkeypatch.setattr(torch.cuda.Stream, "synchronize", refuse)
    monkeypatch.setattr(torch, "tensor", refuse)
    timings = {}
    for on in (False, True):
        with (recording() if on else _nothing()):
            with span("root", timings):
                with span("wait.fetch"):
                    pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with span("profiled"):
            pass
    assert timings["root"] >= 0.0


class _nothing:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


@pytest.fixture(scope="module")
def traced_round(tmp_path_factory):
    """One honest round of a tiny CPU network, recorded: {"spans", "report"}."""
    pipe = perturb_zero_params(build_pipeline("zeroscope-tiny-hf", device="cpu"), seed=99)
    cfg = ValidatorConfig(num_steps=STEPS, num_frames=FRAMES, ping_timeout_s=30,
                          results_dir=str(tmp_path_factory.mktemp("results")))
    net = build_mock_network(n_miners=1, pipeline=pipe, validator_config=cfg, device="cpu")
    net.miners[0].config.spool_dir = str(tmp_path_factory.mktemp("spool"))
    since = last_id()
    loop = asyncio.new_event_loop()
    try:
        with recording():
            report = loop.run_until_complete(net.run_request("trace-1", "a red ball"))
    finally:
        loop.close()
    proof = net.miners[0]._load_proof("trace-1")
    return {"spans": new_spans(since), "report": report, "proof": proof}


def miner_entry(traced_round) -> dict:
    (d,) = traced_round["report"]["miners"].values()
    return d


def tree(traced_round, root_name):
    """(the one root span named ``root_name``, its spans by parent id)."""
    got = traced_round["spans"]
    kids = children(got)
    (root,) = [s for s in got if s.name == root_name]
    assert root.parent == 0
    return root, children(under(kids, root))


def test_a_miner_request_emits_its_span_tree(traced_round):
    root, kids = tree(traced_round, "miner.request")
    assert names(kids, root) == ["miner.verify_request", "generate", "merkle_commit",
                                 "encode_mp4", "sign_proof"]
    (gen,) = [s for s in kids[root.id] if s.name == "generate"]
    assert names(kids, gen) == ["dispatch_loop", "wait.compute", "wait.leaf_fetch",
                                "wait.video_fetch"]
    (loop,) = kids[gen.id][:1]
    assert names(kids, loop) == ["wait.ids_upload", "text_encode", "base_noise",
                                 "denoise_segment", "vae_decode"]
    (segment,) = [s for s in kids[loop.id] if s.name == "denoise_segment"]
    steps = kids[segment.id]
    assert [s.name for s in steps] == ["denoise_step"] * STEPS
    for step in steps:
        assert names(kids, step) == ["unet", "wait.scalar_upload", "ddim_update"]
        (unet,) = kids[step.id][:1]
        assert names(kids, unet) == ["unet.down0", "unet.down1", "unet.mid", "unet.up1",
                                     "unet.up0"]
    for s in kids[gen.id]:
        if s.name.startswith("wait."):
            assert kids[s.id] == []
    (commit,) = [s for s in kids[root.id] if s.name == "merkle_commit"]
    assert names(kids, commit) == ["leaf_hash", "merkle_tree", "proof_spool"]


def test_an_audit_emits_its_span_tree(traced_round):
    verify, kids = tree(traced_round, "validator.verify")
    assert names(kids, verify) == ["video_decode", "authenticity", "audit", "mdvqs_score"]
    (audit,) = [s for s in kids[verify.id] if s.name == "audit"]
    assert names(kids, audit) == ["reveal_roundtrip", "leaf_verify", "base_noise",
                                  "reexecution", "video_binding"]
    phase = {s.name: s for s in kids[audit.id]}
    checks = miner_entry(traced_round)["spotcheck_indices"]
    revealed = {0, STEPS - 1} | set(checks) | {i + 1 for i in checks if i + 1 < STEPS}
    assert names(kids, phase["leaf_verify"]) == ["leaf_hash"] * len(revealed)
    assert names(kids, phase["base_noise"]) == (["wait.scalar_upload"] * FRAMES
                                                + ["wait.noise_fetch", "compare"])
    want = ["wait.ids_upload", "text_encode"] + [
        "wait.step_upload", "denoise_step", "wait.step_fetch"] * len(
        checks) + ["compare"] * len(checks)
    assert names(kids, phase["reexecution"]) == want
    assert names(kids, phase["video_binding"]) == (
        ["wait.leaf_upload", "ddim_update"]
        + ["wait.frame_upload", "vae_decode", "wait.decode_fetch", "compare"] * 2)
    # the miner's side of the reveal is a root of its own, inside the round trip
    reveal, reveal_kids = tree(traced_round, "miner.reveal")
    assert names(reveal_kids, reveal) == ["proof_load", "merkle_paths"]
    assert phase["reveal_roundtrip"].start_ns <= reveal.start_ns
    assert reveal.end_ns <= phase["reveal_roundtrip"].end_ns


def test_the_roles_timing_keys_are_kept(traced_round):
    d = miner_entry(traced_round)
    assert d["checks"]["reexecution"] is True
    assert set(d["miner_timings_s"]) == MINER_TIMINGS
    assert set(d["timings_s"]) == VERIFY_TIMINGS
    assert set(d["mdvqs"]["timings_s"]) == {"clip_pf", "perceptual_vq", "flow_tc"}
    for key in VERIFY_TIMINGS:
        assert d["timings_s"][key] == round(d["timings_s"][key], 4) >= 0.0
    # a timing is its span's seconds
    by_name = {s.name: s for s in traced_round["spans"]}
    for key, name in (("reexecution", "reexecution"), ("merkle_verify", "leaf_verify")):
        s = by_name[name]
        assert d["timings_s"][key] == round((s.end_ns - s.start_ns) / 1e9, 4)
    assert np.isclose(d["miner_timings_s"]["generate"], d["gen_time_s"], atol=6e-5)
