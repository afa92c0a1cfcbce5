from githubrepostorag_tpu_torch.worker.worker import RagWorker

__all__ = ["RagWorker"]
