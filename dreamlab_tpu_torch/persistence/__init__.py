from .storage_provider import (
    StorageItem,
    StorageProvider,
    InMemoryStorageProvider,
    make_storage_provider_from_env,
)
from .filesystem_provider import FilesystemStorageProvider

__all__ = [
    "StorageItem",
    "StorageProvider",
    "InMemoryStorageProvider",
    "FilesystemStorageProvider",
    "make_storage_provider_from_env",
]
