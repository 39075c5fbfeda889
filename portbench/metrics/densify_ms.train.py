"""Device ms a densify round, by CUDA events at the trainer's marks: the
`densify` span's stages (`densify/masks`, `densify/assign`,
`densify/fill`, `densify/log`, `densify`) and `reset alpha`, over the
events stretch, divided by the rounds the schedule puts in it."""


def read(r):
    return r.get("densify", {}).get("ms")
