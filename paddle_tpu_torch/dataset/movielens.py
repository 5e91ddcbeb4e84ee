"""MovieLens recommender readers (reference:
python/paddle/dataset/movielens.py). Samples:
(user_id, gender, age, job, movie_id, category_ids, title_ids, rating).

A copy of ``paddle_tpu/dataset/movielens.py``: the same
samples, from the same seeds in the same order."""

from __future__ import annotations

import numpy as np

MAX_USER = 6040
MAX_MOVIE = 3952
CATEGORIES = 18
AGES = 7
JOBS = 21
TITLE_DICT = 5174


def max_user_id():
    return MAX_USER


def max_movie_id():
    return MAX_MOVIE


def max_job_id():
    return JOBS - 1


def age_table():
    return [1, 18, 25, 35, 45, 50, 56]


def _synthetic(n, seed):
    rng = np.random.RandomState(seed)
    for _ in range(n):
        user = int(rng.randint(1, MAX_USER + 1))
        gender = int(rng.randint(0, 2))
        age = int(rng.randint(0, AGES))
        job = int(rng.randint(0, JOBS))
        movie = int(rng.randint(1, MAX_MOVIE + 1))
        cats = rng.randint(0, CATEGORIES, rng.randint(1, 4)).tolist()
        title = rng.randint(0, TITLE_DICT, rng.randint(1, 6)).tolist()
        # structured rating: users & movies have latent quality
        rating = float(np.clip(((user % 5) + (movie % 5)) / 2.0 + rng.randn() * 0.3,
                               0, 5))
        yield user, gender, age, job, movie, cats, title, rating


def train():
    return lambda: _synthetic(8192, 0)


def test():
    return lambda: _synthetic(1024, 1)
