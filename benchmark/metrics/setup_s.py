"""Seconds from process start to the window's first step: the set
drawn and written, the program built, the warm-up epoch (its kernel
builds on a checkout's first run)."""


def read(ctx):
    return ctx["setup_s"]
