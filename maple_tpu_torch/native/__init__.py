from .bridge import NativeStore, native_available  # noqa: F401
