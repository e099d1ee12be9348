"""Deep-biasing (context-adaptor) data mining.

The port's copy of reverb_tpu/data/deep_bias.py (reference
asr/wenet/dataset/processor.py:119-177 rare-word CV-phrase mining and
distractors, :477-507 tokenization, :655-678 batch assembly with the
distractor ratio and the epoch-ramped term count).  Like the JAX package it
draws from Python's global `random` (seed it for a repeatable stream).
"""

from __future__ import annotations

import json
import math
import random
from typing import Dict, List, Optional, Set


def get_rare_words(deep_bias_conf: Dict) -> Set[str]:
    rare = set()
    threshold = deep_bias_conf.get('freq_threshold', 20)
    with open(deep_bias_conf['word_freqs']) as f:
        freqs = json.load(f)
    for word, freq in freqs.items():
        if word.isalpha() and freq <= threshold:
            rare.add(word)
    return rare


def rare_utt_filter(sample: Optional[Dict], rare_words: Set[str],
                    conf: Dict) -> Optional[Dict]:
    """Keep only utterances containing rare words; mine CV phrases (up to
    n_order context words ending at the rare word) and distractor phrases."""
    if sample is None:
        return None
    p_keep = conf.get('p_keep', 1)
    n_order = conf.get('n_order', 3)
    words = sample['txt'].split()
    cv_terms: List[str] = []
    dist_terms: List[str] = []
    for word in words:
        if word not in rare_words:
            continue
        i = words.index(word)
        n = random.randrange(n_order)
        if n >= len(words):
            n = 1
        lo = 0 if n > i else i - n
        cv_terms.append(' '.join(words[lo:i + 1]))
        dist = random.sample(words, min(n, len(words)))
        if word in dist:
            dist.remove(word)
        dist.append(random.choice(sorted(rare_words)))
        random.shuffle(dist)
        dist_terms.append(' '.join(dist))
    if not cv_terms:
        return None
    sample['cv_list'] = cv_terms if random.random() < p_keep else []
    sample['cv_distractors'] = dist_terms
    return sample


def tokenize_cv_list(sample: Dict, tokenizer) -> Dict:
    sample['cv_tokens_list'], sample['cv_label_list'] = [], []
    for phrase in sample.get('cv_list', []):
        toks, ids = tokenizer.tokenize(phrase)
        sample['cv_tokens_list'].append(toks)
        sample['cv_label_list'].append(ids)
    sample['dist_tokens_list'], sample['dist_label_list'] = [], []
    for phrase in sample.get('cv_distractors', []):
        toks, ids = tokenizer.tokenize(phrase)
        sample['dist_tokens_list'].append(toks)
        sample['dist_label_list'].append(ids)
    return sample


def filter_cv_by_epoch(terms: List, conf: Dict) -> List:
    """The share of the bias terms that the epoch ramp keeps.  The JAX
    package's epoch counter is never advanced, so its ramp always takes
    epoch 0; so does this one."""
    total = len(terms)
    max_epoch = conf.get('max_epoch', 10)
    target = min(total, math.ceil(total / (max_epoch + 1)))
    return random.sample(terms, target)


def batch_cv_list(samples: List[Dict], conf: Dict) -> List[tuple]:
    """A batch's bias terms: its CV phrases, a `distractor_ratio` share of
    its distractors, ramped as at epoch 0."""
    cv = [tuple(t) for s in samples for t in s.get('cv_label_list', [])]
    dist = [tuple(t) for s in samples for t in s.get('dist_label_list', [])]
    ratio = conf.get('distractor_ratio', 0.2)
    n_dist = round(len(dist) * ratio)
    terms = cv + random.sample(dist, n_dist)
    return filter_cv_by_epoch(terms, conf)
