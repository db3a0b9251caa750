"""The benchmark of jsplayer_tpu_torch, the PyTorch and CUDA port.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json once on one card (run.py).  The harness
(harness.py) drives jsplayer_tpu_torch.VideoIngestPipeline in a closed
loop and judges what it delivered against the plain reference
(references/, judge.py); the inputs come from the benchmark's own frozen
recipes and encoders (inputs.py, recipes/, encode/); a traced run reads
spans, counters and torch.profiler's device trace (trace.py, spans/,
counters/, metrics/).  spec.py says how each kind of file is found by
name.  Nothing here imports JAX or the JAX package.
"""
