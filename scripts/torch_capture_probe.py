"""Which object's destruction, or which first use, inside a thread-local
CUDA-graph capture invalidates the capture.

Each case makes one kind of object (a tensor, an event, a captured CUDA
graph, a pinned buffer, a stream, a generator, ...) unreachable in a
reference cycle, then runs ``gc.collect()`` inside a capture between two
launches (or makes one call there: ``empty_cache``, a kernel's first use,
an event query on another stream), and prints whether the capture broke.
Each case runs in its own process, all at once.

    python3 scripts/torch_capture_probe.py          # every case
    python3 scripts/torch_capture_probe.py graph_new  # one case

Needs a CUDA card. ``runtime/graphs.py:collector_held`` rests on its
reading: of the objects, only a dropped CUDA graph breaks a capture (of
the calls, the event query does, as a synchronizing call should)."""
import gc
import json
import subprocess
import sys

CASES = ["none", "empty_cache", "tensor", "event", "timed_event", "graph_replayed", "graph_new",
         "pinned", "stream", "side_stream_tensor", "profiler_before", "first_use_kernel",
         "cuda_generator", "graph_in_cycle_pool_reuse", "profiler_then_graph_garbage",
         "sync_event_query_other"]


def run(case):
    import torch
    dev = torch.device("cuda", 0)
    x = torch.ones(4096, device=dev)
    (x * 2 + 1).sum()
    torch.cuda.synchronize()
    junk = None
    if case == "tensor":
        junk = torch.randn(1 << 20, device=dev)
    elif case == "event":
        junk = torch.cuda.Event()
        junk.record()
    elif case == "timed_event":
        junk = torch.cuda.Event(enable_timing=True)
        junk.record()
        junk.synchronize()
    elif case in ("graph_replayed", "graph_new", "graph_in_cycle_pool_reuse", "profiler_then_graph_garbage"):
        if case == "profiler_then_graph_garbage":
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                (x * 3).sum()
                torch.cuda.synchronize()
        s = torch.cuda.Stream()
        s.wait_stream(torch.cuda.current_stream())
        g = torch.cuda.CUDAGraph()
        with torch.cuda.stream(s):
            g.capture_begin()
            y = x * 5
            g.capture_end()
        torch.cuda.current_stream().wait_stream(s)
        if case != "graph_new":
            g.replay()
            torch.cuda.synchronize()
        junk = [g, y]
    elif case == "pinned":
        junk = torch.empty(1 << 20, pin_memory=True)
        junk.copy_(torch.randn(1 << 20, device=dev), non_blocking=True)
    elif case == "stream":
        junk = torch.cuda.Stream()
    elif case == "side_stream_tensor":
        s2 = torch.cuda.Stream()
        with torch.cuda.stream(s2):
            t = torch.randn(1 << 20, device=dev)
        t.record_stream(torch.cuda.current_stream())
        junk = t
    elif case == "profiler_before":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            (x * 3).sum()
            torch.cuda.synchronize()
    elif case == "cuda_generator":
        junk = torch.Generator(device=dev).manual_seed(0)
    if junk is not None:
        cyc = [junk]
        cyc.append(cyc)
        del cyc, junk
    gc.disable()
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    g = torch.cuda.CUDAGraph()
    err = None
    with torch.cuda.stream(s):
        g.capture_begin(capture_error_mode="thread_local")
        try:
            y = x * 7
            if case == "empty_cache":
                torch.cuda.empty_cache()
            elif case == "first_use_kernel":
                torch.cummax(torch.arange(100, device=dev, dtype=torch.int16), 0)
            elif case == "sync_event_query_other":
                e = torch.cuda.Event()
                e.record(torch.cuda.default_stream())
                e.query()
            else:
                gc.collect()
            z = y + 1
        except Exception as e:  # noqa: BLE001
            err = f"{type(e).__name__}: {str(e).splitlines()[0]}"
        try:
            g.capture_end()
        except Exception as e:  # noqa: BLE001
            err = err or f"end {type(e).__name__}: {str(e).splitlines()[0]}"
    print(json.dumps({"case": case, "error": err}))


if __name__ == "__main__":
    if len(sys.argv) > 1:
        run(sys.argv[1])
    else:
        procs = {c: subprocess.Popen([sys.executable, __file__, c], stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True) for c in CASES}
        for c, p in procs.items():
            out, errs = p.communicate(timeout=300)
            print(c, "rc", p.returncode, out.strip().splitlines()[-1:] if out.strip() else errs.strip().splitlines()[-2:])
