from repro_torch.storage.store import BlobStore  # noqa: F401
