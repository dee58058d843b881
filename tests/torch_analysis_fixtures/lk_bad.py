"""LK* fixtures: unlocked writes to lock-guarded attributes."""
import threading


class Counter:
    def __init__(self):
        self._lock = threading.Lock()
        self._n = 0

    def bump(self):
        with self._lock:
            self._n += 1

    def reset(self):
        self._n = 0              # LK01: unlocked write, guarded attr


class Pending:
    def __init__(self):
        self._lock = threading.Lock()
        self._items = []

    def put(self, item):
        with self._lock:
            self._items.append(item)

    def drop_all(self):
        self._items.clear()      # LK02: unlocked mutation, guarded attr
