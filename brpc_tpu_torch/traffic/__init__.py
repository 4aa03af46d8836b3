"""Traffic capture (the port of brpc_tpu/traffic/): ``capture.py``, the
sampled recorder hooked into the server's dispatch with its writer
thread, rotation and disk budget, runtime control on ``/capture``; and
``corpus.py``, the indexed ``.brpccap`` format over recordio. Replay and
press (``replay.py``) wait for the tools (ROADMAP section 1)."""

from brpc_tpu_torch.traffic.corpus import (CapturedRequest, CorpusReader,
                                           CorpusWriter, merge_corpora)

__all__ = ["CapturedRequest", "CorpusReader", "CorpusWriter",
           "merge_corpora"]
