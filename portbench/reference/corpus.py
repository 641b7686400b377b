"""The federated cell's corpus, made by the benchmark and handed to both
sides.

A frozen copy of the text generator of ``repro_torch.data.shakespeare``
(passages, speakers, ``_expand``): with no ``data/input.txt`` the
program's own corpus is this text, and the benchmark builds it here so
that the reference reads the same characters without importing the
program. ``corpus()`` -> (train ids, val ids, vocabulary size), split
as ``load_corpus`` splits it (the last tenth is validation).
"""
from __future__ import annotations

import numpy as np

_PASSAGES = [
    """To be, or not to be, that is the question:
Whether 'tis nobler in the mind to suffer
The slings and arrows of outrageous fortune,
Or to take arms against a sea of troubles
And by opposing end them. To die: to sleep;
No more; and by a sleep to say we end
The heart-ache and the thousand natural shocks
That flesh is heir to, 'tis a consummation
Devoutly to be wish'd. To die, to sleep;
To sleep: perchance to dream: ay, there's the rub.""",
    """Shall I compare thee to a summer's day?
Thou art more lovely and more temperate:
Rough winds do shake the darling buds of May,
And summer's lease hath all too short a date.""",
    """Tomorrow, and tomorrow, and tomorrow,
Creeps in this petty pace from day to day
To the last syllable of recorded time,
And all our yesterdays have lighted fools
The way to dusty death. Out, out, brief candle!
Life's but a walking shadow, a poor player
That struts and frets his hour upon the stage
And then is heard no more.""",
    """Now is the winter of our discontent
Made glorious summer by this sun of York;
And all the clouds that lour'd upon our house
In the deep bosom of the ocean buried.""",
    """Friends, Romans, countrymen, lend me your ears;
I come to bury Caesar, not to praise him.
The evil that men do lives after them;
The good is oft interred with their bones.""",
    """All the world's a stage,
And all the men and women merely players:
They have their exits and their entrances;
And one man in his time plays many parts.""",
    """If music be the food of love, play on;
Give me excess of it, that, surfeiting,
The appetite may sicken, and so die.""",
    """The quality of mercy is not strain'd,
It droppeth as the gentle rain from heaven
Upon the place beneath: it is twice blest;
It blesseth him that gives and him that takes.""",
    """O Romeo, Romeo! wherefore art thou Romeo?
Deny thy father and refuse thy name;
Or, if thou wilt not, be but sworn my love,
And I'll no longer be a Capulet.""",
    """Once more unto the breach, dear friends, once more;
Or close the wall up with our English dead.
In peace there's nothing so becomes a man
As modest stillness and humility.""",
]

_SPEAKERS = ["HAMLET", "MACBETH", "PORTIA", "BRUTUS", "ROSALIND", "HENRY",
             "JULIET", "VIOLA", "PROSPERO", "OTHELLO", "KING LEAR", "PUCK"]


def _expand(target_bytes: int, seed: int = 1337) -> str:
    rng = np.random.default_rng(seed)
    parts = []
    size = 0
    while size < target_bytes:
        sp = _SPEAKERS[int(rng.integers(len(_SPEAKERS)))]
        ps = _PASSAGES[int(rng.integers(len(_PASSAGES)))]
        # vary passages by dropping a random suffix of lines
        lines = ps.split("\n")
        keep = int(rng.integers(2, len(lines) + 1))
        block = f"{sp}:\n" + "\n".join(lines[:keep]) + "\n\n"
        parts.append(block)
        size += len(block)
    return "".join(parts)[:target_bytes]


def corpus(target_bytes: int = 600_000, val_frac: float = 0.1):
    text = _expand(target_bytes)
    chars = sorted(set(text))
    stoi = {c: i for i, c in enumerate(chars)}
    data = np.array([stoi[c] for c in text], np.int32)
    n_val = int(len(data) * val_frac)
    return data[:-n_val], data[-n_val:], len(chars), chars


def sample_batch(data: np.ndarray, rng: np.random.Generator, batch: int,
                 seq: int):
    """(tokens, targets), each (batch, seq) int32: ``batch`` windows at
    offsets drawn from ``rng``, the targets one character on."""
    ix = rng.integers(0, len(data) - seq - 1, size=batch)
    toks = np.stack([data[i:i + seq] for i in ix])
    targs = np.stack([data[i + 1:i + seq + 1] for i in ix])
    return toks, targs
