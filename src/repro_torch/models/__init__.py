"""Model code of the port: layers, paged attention blocks, the dense
decoder's decode step and chunked prefill, and the RWKV6 / Mamba2
linear recurrences (:mod:`repro_torch.models.ssm`)."""

from repro_torch.models.model import (PagedCache, cast_params, decode_step,
                                      init_paged_cache, init_params,
                                      prefill_chunk)

__all__ = ["PagedCache", "cast_params", "decode_step", "init_paged_cache",
           "init_params", "prefill_chunk"]
