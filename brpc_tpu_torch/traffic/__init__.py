"""Traffic capture and replay (the port of brpc_tpu/traffic/):
``capture.py``, the sampled recorder hooked into the server's dispatch
with its writer thread, rotation and disk budget, runtime control on
``/capture``; ``corpus.py``, the indexed ``.brpccap`` format over
recordio; and ``replay.py``, the open-loop replay and press engine
(recorded pacing with a time warp, constant qps or seeded Poisson).
The command lines are ``brpc_tpu_torch.tools.rpc_press``,
``rpc_replay`` and ``rpc_view``."""

from brpc_tpu_torch.traffic.corpus import (CapturedRequest, CorpusReader,
                                           CorpusWriter, merge_corpora)

__all__ = ["CapturedRequest", "CorpusReader", "CorpusWriter",
           "merge_corpora"]
