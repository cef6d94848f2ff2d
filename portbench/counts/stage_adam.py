"""Adam over every parameter: reads the parameter, its gradient and both
moments, writes the parameter and both moments (7 f32 a parameter);
about 12 operations a parameter."""


def count(s):
    return {"ops": 12 * s.n_params, "bytes": 28 * s.n_params, "peak": "f32"}
