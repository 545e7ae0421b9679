"""Credential stores: a small port over the OS keychain plus test fakes.

Parity targets (reference: src/config/store.rs:25-129):
- get returns None when absent (not an error);
- set/delete; delete is idempotent;
- a broken store degrades gracefully (callers warn and fall back to env);
- InMemoryStore (+ failing()) is the hermetic test fake.

The OS keychain is optional here: the ``keyring`` package may be absent in the
headless server image, in which case KeychainStore reports itself unavailable and
every operation fails cleanly (env-variable credentials still work).
"""

from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

SERVICE_NAME = "openintel"


class StoreError(Exception):
    """A credential store operation failed (broken keychain, missing backend)."""


@runtime_checkable
class CredentialStore(Protocol):
    def get(self, key: str) -> Optional[str]: ...

    def set(self, key: str, value: str) -> None: ...

    def delete(self, key: str) -> None: ...


class KeychainStore:
    """OS keychain store via the ``keyring`` package (service name "openintel").

    If ``keyring`` is unavailable or broken, every call raises StoreError; the
    credential loader treats that as "warn and fall back to env".
    """

    def __init__(self) -> None:
        try:
            import keyring  # type: ignore

            self._keyring = keyring
        except Exception:  # pragma: no cover - depends on image contents
            self._keyring = None

    def _backend(self):
        if self._keyring is None:
            raise StoreError("keyring backend unavailable")
        return self._keyring

    def get(self, key: str) -> Optional[str]:
        try:
            return self._backend().get_password(SERVICE_NAME, key)
        except StoreError:
            raise
        except Exception as e:  # pragma: no cover
            raise StoreError(str(e)) from e

    def set(self, key: str, value: str) -> None:
        try:
            self._backend().set_password(SERVICE_NAME, key, value)
        except StoreError:
            raise
        except Exception as e:  # pragma: no cover
            raise StoreError(str(e)) from e

    def delete(self, key: str) -> None:
        """Idempotent: deleting an absent key succeeds."""
        try:
            backend = self._backend()
        except StoreError:
            raise
        try:
            backend.delete_password(SERVICE_NAME, key)
        except StoreError:
            raise
        except Exception:
            # keyring raises PasswordDeleteError for absent keys — idempotent.
            return


class InMemoryStore:
    """Hermetic fake store; ``failing()`` simulates a broken keychain
    (reference: src/config/store.rs:74-129)."""

    def __init__(self, fail: bool = False) -> None:
        self._data: dict[str, str] = {}
        self._fail = fail

    @staticmethod
    def failing() -> "InMemoryStore":
        return InMemoryStore(fail=True)

    def get(self, key: str) -> Optional[str]:
        if self._fail:
            raise StoreError("simulated keychain failure")
        return self._data.get(key)

    def set(self, key: str, value: str) -> None:
        if self._fail:
            raise StoreError("simulated keychain failure")
        self._data[key] = value

    def delete(self, key: str) -> None:
        if self._fail:
            raise StoreError("simulated keychain failure")
        self._data.pop(key, None)
