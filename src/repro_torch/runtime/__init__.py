from repro_torch.runtime.scheduler import ChunkLedger, WorkScheduler, WorkerPool
