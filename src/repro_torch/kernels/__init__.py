"""Hand-written Hopper kernels of the port, one directory per kernel with
its CUDA source under ``csrc/``, Python wrappers, a plain PyTorch version
(``ref.py``) and public ops (``ops.py``); ``_build.py`` compiles and binds
them:

  race_lookup/       batched one-sided KV lookup over a RACE hash table
                     in device memory (the meta-server / DrTM-KV data path)
  serverless_stage/  the masked chunk gather that packs and unpacks the
                     serverless chain hop's payload slabs
  flash_attention/   blockwise GQA attention with an online softmax (the
                     models' full-sequence attention)
  rwkv6/             the chunked RWKV-6 WKV scan (rwkv6's time mix)
"""
