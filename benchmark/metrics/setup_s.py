"""setup_s: host seconds from the process's start to the window's."""


def read(data):
    return data.get("setup_s")
