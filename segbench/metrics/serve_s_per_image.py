"""Seconds per served image: the window, from the first image handed to the
stream to the first mask back after ``--seconds``, over the masks back in it."""


def read(rec):
    serve = rec.get("serve")
    return serve["window_s"] / serve["images"] if serve and serve["images"] else None
