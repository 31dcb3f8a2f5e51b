"""The benchmark of the PyTorch and CUDA port (``p2p_llm_chat_tpu_torch``).

One run measures one cell of ``BENCHMARK.json``::

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""
