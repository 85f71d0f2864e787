from repro_torch.bufferpool.pool import (BufferPool, PartitionedBufferPool,
                                         PoolConfig)
