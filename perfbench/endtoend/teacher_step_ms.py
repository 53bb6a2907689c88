"""The window's milliseconds over the teacher's training steps it
completed, the host's rays and pixel draws included (host clock; the window
ends when the card has finished its last step)."""


def read(window):
    return window.seconds * 1e3 / window.requests
