"""Wire codecs, counter RNG, key derivation and the neighbour exchange of
the consensus rounds."""
from repro_torch.comm.exchange import DistExchange, ThreadExchange, spmd_run

__all__ = ["DistExchange", "ThreadExchange", "spmd_run"]
