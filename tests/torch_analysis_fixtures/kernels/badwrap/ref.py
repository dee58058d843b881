"""The fixture kernel's plain version."""


def badwrap_ref(x):
    return x * 2
