"""Version information for heat_tpu_torch (``heat_tpu``'s ``version``
module, the same fields)."""

major: int = 0
"""Major version (API-incompatible changes)."""
minor: int = 1
"""Minor version (backward-compatible features)."""
micro: int = 0
"""Micro version (bug fixes)."""
extension: str = "dev"
"""Pre-release tag."""

if not extension:
    __version__: str = f"{major}.{minor}.{micro}"
else:
    __version__: str = f"{major}.{minor}.{micro}-{extension}"
