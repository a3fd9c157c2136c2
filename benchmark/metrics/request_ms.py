"""Window ms over the requests completed in it; the window ends when
the request in flight at --seconds is done."""


def read(run):
    return (1e3 * run["window_s"] / run["units"]
            if run["unit"] == "requests" and run["units"] else None)
