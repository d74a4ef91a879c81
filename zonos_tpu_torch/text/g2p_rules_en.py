"""English letter-to-sound rules and exception lexicon for the built-in G2P.

Context-sensitive rewrite rules in the classic text-to-phoneme style
(left-context, grapheme, right-context -> phones).  Context pattern atoms:

    '#'  one or more vowel letters
    '^'  exactly one consonant letter
    ':'  zero or more consonant letters
    '.'  one voiced consonant (b d g j l m n r v w z)
    '%'  an e-family suffix (e, er, es, ed, ely, ing)
    '&'  a sibilant cluster (s, c, g, z, x, j, ch, sh)
    '@'  a consonant after which long u is pronounced /u/ not /ju/ (t s r d l z n j th ch sh)
    ' '  word boundary
    other characters match literally

Phones are ARPABET-like tokens, converted to IPA by the engine.  The rule
set is ordered: the first matching rule for the longest grapheme wins.
"""

from __future__ import annotations

# Exception lexicon: irregular + very frequent words (ARPABET, '1' marks the
# stressed vowel by preceding token index convention: stress attaches to the
# vowel token it follows).
LEXICON: dict[str, str] = {
    "a": "AH0", "an": "AH0 N", "the": "DH AH0", "of": "AH0 V", "to": "T UW1",
    "and": "AH0 N D", "in": "IH0 N", "is": "IH1 Z", "it": "IH1 T", "you": "Y UW1",
    "that": "DH AE1 T", "he": "HH IY1", "she": "SH IY1", "was": "W AH1 Z",
    "for": "F AO1 R", "on": "AA1 N", "are": "AA1 R", "as": "AE1 Z", "with": "W IH1 DH",
    "his": "HH IH1 Z", "they": "DH EY1", "I": "AY1", "i": "AY1", "at": "AE1 T",
    "be": "B IY1", "this": "DH IH1 S", "have": "HH AE1 V", "from": "F R AH1 M",
    "or": "AO1 R", "one": "W AH1 N", "had": "HH AE1 D", "by": "B AY1",
    "word": "W ER1 D", "but": "B AH1 T", "not": "N AA1 T", "what": "W AH1 T",
    "all": "AO1 L", "were": "W ER1", "we": "W IY1", "when": "W EH1 N",
    "your": "Y AO1 R", "can": "K AE1 N", "said": "S EH1 D", "there": "DH EH1 R",
    "use": "Y UW1 S", "each": "IY1 CH", "which": "W IH1 CH", "do": "D UW1",
    "how": "HH AW1", "their": "DH EH1 R", "if": "IH1 F", "will": "W IH1 L",
    "up": "AH1 P", "other": "AH1 DH ER0", "about": "AH0 B AW1 T",
    "out": "AW1 T", "many": "M EH1 N IY0", "then": "DH EH1 N", "them": "DH EH1 M",
    "these": "DH IY1 Z", "so": "S OW1", "some": "S AH1 M", "her": "HH ER1",
    "would": "W UH1 D", "make": "M EY1 K", "like": "L AY1 K", "him": "HH IH1 M",
    "into": "IH1 N T UW0", "time": "T AY1 M", "has": "HH AE1 Z", "look": "L UH1 K",
    "two": "T UW1", "more": "M AO1 R", "write": "R AY1 T", "go": "G OW1",
    "see": "S IY1", "no": "N OW1", "way": "W EY1", "could": "K UH1 D",
    "people": "P IY1 P AH0 L", "my": "M AY1", "than": "DH AE1 N",
    "first": "F ER1 S T", "water": "W AO1 T ER0", "been": "B IH1 N",
    "who": "HH UW1", "its": "IH1 T S", "now": "N AW1", "find": "F AY1 N D",
    "long": "L AO1 NG", "down": "D AW1 N", "day": "D EY1", "did": "D IH1 D",
    "get": "G EH1 T", "come": "K AH1 M", "made": "M EY1 D", "may": "M EY1",
    "part": "P AA1 R T", "over": "OW1 V ER0", "new": "N UW1", "sound": "S AW1 N D",
    "take": "T EY1 K", "only": "OW1 N L IY0", "little": "L IH1 T AH0 L",
    "work": "W ER1 K", "know": "N OW1", "place": "P L EY1 S", "year": "Y IH1 R",
    "live": "L IH1 V", "me": "M IY1", "back": "B AE1 K", "give": "G IH1 V",
    "most": "M OW1 S T", "very": "V EH1 R IY0", "after": "AE1 F T ER0",
    "thing": "TH IH1 NG", "our": "AW1 ER0", "just": "JH AH1 S T",
    "name": "N EY1 M", "good": "G UH1 D", "sentence": "S EH1 N T AH0 N S",
    "man": "M AE1 N", "think": "TH IH1 NG K", "say": "S EY1",
    "great": "G R EY1 T", "where": "W EH1 R", "help": "HH EH1 L P",
    "through": "TH R UW1", "much": "M AH1 CH", "before": "B IH0 F AO1 R",
    "line": "L AY1 N", "right": "R AY1 T", "too": "T UW1", "mean": "M IY1 N",
    "old": "OW1 L D", "any": "EH1 N IY0", "same": "S EY1 M", "tell": "T EH1 L",
    "boy": "B OY1", "follow": "F AA1 L OW0", "came": "K EY1 M",
    "want": "W AA1 N T", "show": "SH OW1", "also": "AO1 L S OW0",
    "around": "ER0 AW1 N D", "form": "F AO1 R M", "three": "TH R IY1",
    "small": "S M AO1 L", "set": "S EH1 T", "put": "P UH1 T", "end": "EH1 N D",
    "does": "D AH1 Z", "another": "AH0 N AH1 DH ER0", "well": "W EH1 L",
    "large": "L AA1 R JH", "must": "M AH1 S T", "big": "B IH1 G",
    "even": "IY1 V AH0 N", "such": "S AH1 CH", "because": "B IH0 K AO1 Z",
    "turn": "T ER1 N", "here": "HH IY1 R", "why": "W AY1", "ask": "AE1 S K",
    "went": "W EH1 N T", "men": "M EH1 N", "read": "R IY1 D", "need": "N IY1 D",
    "land": "L AE1 N D", "different": "D IH1 F ER0 AH0 N T",
    "home": "HH OW1 M", "us": "AH1 S", "move": "M UW1 V", "try": "T R AY1",
    "kind": "K AY1 N D", "hand": "HH AE1 N D", "picture": "P IH1 K CH ER0",
    "again": "AH0 G EH1 N", "change": "CH EY1 N JH", "off": "AO1 F",
    "play": "P L EY1", "spell": "S P EH1 L", "air": "EH1 R", "away": "AH0 W EY1",
    "animal": "AE1 N AH0 M AH0 L", "house": "HH AW1 S", "point": "P OY1 N T",
    "page": "P EY1 JH", "letter": "L EH1 T ER0", "mother": "M AH1 DH ER0",
    "answer": "AE1 N S ER0", "found": "F AW1 N D", "study": "S T AH1 D IY0",
    "still": "S T IH1 L", "learn": "L ER1 N", "should": "SH UH1 D",
    "world": "W ER1 L D", "high": "HH AY1", "every": "EH1 V ER0 IY0",
    "near": "N IH1 R", "add": "AE1 D", "food": "F UW1 D",
    "between": "B IH0 T W IY1 N", "own": "OW1 N", "below": "B IH0 L OW1",
    "country": "K AH1 N T R IY0", "plant": "P L AE1 N T",
    "last": "L AE1 S T", "school": "S K UW1 L", "father": "F AA1 DH ER0",
    "keep": "K IY1 P", "tree": "T R IY1", "never": "N EH1 V ER0",
    "start": "S T AA1 R T", "city": "S IH1 T IY0", "earth": "ER1 TH",
    "eye": "AY1", "light": "L AY1 T", "thought": "TH AO1 T",
    "head": "HH EH1 D", "under": "AH1 N D ER0", "story": "S T AO1 R IY0",
    "saw": "S AO1", "left": "L EH1 F T", "don't": "D OW1 N T",
    "few": "F Y UW1", "while": "W AY1 L", "along": "AH0 L AO1 NG",
    "might": "M AY1 T", "close": "K L OW1 S", "something": "S AH1 M TH IH0 NG",
    "seem": "S IY1 M", "next": "N EH1 K S T", "hard": "HH AA1 R D",
    "open": "OW1 P AH0 N", "example": "IH0 G Z AE1 M P AH0 L",
    "begin": "B IH0 G IH1 N", "life": "L AY1 F", "always": "AO1 L W EY0 Z",
    "those": "DH OW1 Z", "both": "B OW1 TH", "paper": "P EY1 P ER0",
    "together": "T AH0 G EH1 DH ER0", "got": "G AA1 T", "group": "G R UW1 P",
    "often": "AO1 F AH0 N", "run": "R AH1 N", "important": "IH0 M P AO1 R T AH0 N T",
    "until": "AH0 N T IH1 L", "children": "CH IH1 L D R AH0 N",
    "side": "S AY1 D", "feet": "F IY1 T", "car": "K AA1 R", "mile": "M AY1 L",
    "night": "N AY1 T", "walk": "W AO1 K", "white": "W AY1 T",
    "sea": "S IY1", "began": "B IH0 G AE1 N", "grow": "G R OW1",
    "took": "T UH1 K", "river": "R IH1 V ER0", "four": "F AO1 R",
    "carry": "K AE1 R IY0", "state": "S T EY1 T", "once": "W AH1 N S",
    "book": "B UH1 K", "hear": "HH IY1 R", "stop": "S T AA1 P",
    "without": "W IH0 DH AW1 T", "second": "S EH1 K AH0 N D",
    "later": "L EY1 T ER0", "miss": "M IH1 S", "idea": "AY0 D IY1 AH0",
    "enough": "IH0 N AH1 F", "eat": "IY1 T", "face": "F EY1 S",
    "watch": "W AA1 CH", "far": "F AA1 R", "really": "R IH1 L IY0",
    "almost": "AO1 L M OW0 S T", "let": "L EH1 T", "above": "AH0 B AH1 V",
    "girl": "G ER1 L", "sometimes": "S AH1 M T AY0 M Z",
    "mountain": "M AW1 N T AH0 N", "cut": "K AH1 T", "young": "Y AH1 NG",
    "talk": "T AO1 K", "soon": "S UW1 N", "list": "L IH1 S T",
    "song": "S AO1 NG", "being": "B IY1 IH0 NG", "leave": "L IY1 V",
    "family": "F AE1 M AH0 L IY0", "it's": "IH1 T S", "body": "B AA1 D IY0",
    "music": "M Y UW1 Z IH0 K", "color": "K AH1 L ER0", "stand": "S T AE1 N D",
    "sun": "S AH1 N", "question": "K W EH1 S CH AH0 N", "fish": "F IH1 SH",
    "area": "EH1 R IY0 AH0", "mark": "M AA1 R K", "dog": "D AA1 G",
    # dog: cot-caught-merged GA (espeak en-us emits ɑː; Wiktionary lists /dɑɡ/)
    "synthesis": "S IH1 N TH AH0 S IH0 S",
    "horse": "HH AO1 R S", "bird": "B ER1 D", "problem": "P R AA1 B L AH0 M",
    "complete": "K AH0 M P L IY1 T", "room": "R UW1 M", "knew": "N UW1",
    "since": "S IH1 N S", "ever": "EH1 V ER0", "piece": "P IY1 S",
    "told": "T OW1 L D", "usually": "Y UW1 ZH AH0 W AH0 L IY0",
    "friend": "F R EH1 N D", "easy": "IY1 Z IY0", "heard": "HH ER1 D",
    "order": "AO1 R D ER0", "red": "R EH1 D", "door": "D AO1 R",
    "sure": "SH UH1 R", "become": "B IH0 K AH1 M", "top": "T AA1 P",
    "ship": "SH IH1 P", "across": "AH0 K R AO1 S", "today": "T AH0 D EY1",
    "during": "D UH1 R IH0 NG", "short": "SH AO1 R T", "better": "B EH1 T ER0",
    "best": "B EH1 S T", "however": "HH AW0 EH1 V ER0", "low": "L OW1",
    "hours": "AW1 ER0 Z", "black": "B L AE1 K", "products": "P R AA1 D AH0 K T S",
    "happened": "HH AE1 P AH0 N D", "whole": "HH OW1 L",
    "measure": "M EH1 ZH ER0", "remember": "R IH0 M EH1 M B ER0",
    "early": "ER1 L IY0", "waves": "W EY1 V Z", "reached": "R IY1 CH T",
    "zonos": "Z OW1 N OW0 S", "espeak": "IY1 S P IY2 K",
    "hello": "HH AH0 L OW1", "world": "W ER1 L D",
    "one": "W AH1 N", "once": "W AH1 N S", "pretty": "P R IH1 T IY0",
    "wolf": "W UH1 L F", "woman": "W UH1 M AH0 N", "women": "W IH1 M AH0 N",
    "iron": "AY1 ER0 N", "island": "AY1 L AH0 N D", "hour": "AW1 ER0",
    "honest": "AA1 N AH0 S T", "honor": "AA1 N ER0", "heir": "EH1 R",
    "colonel": "K ER1 N AH0 L", "choir": "K W AY1 ER0", "yacht": "Y AA1 T",
    "quay": "K IY1", "busy": "B IH1 Z IY0", "business": "B IH1 Z N AH0 S",
    "laugh": "L AE1 F", "tough": "T AH1 F", "rough": "R AH1 F",
    "cough": "K AO1 F", "dough": "D OW1", "though": "DH OW1",
    "bought": "B AO1 T", "brought": "B R AO1 T", "caught": "K AO1 T",
    "daughter": "D AO1 T ER0", "eight": "EY1 T", "weight": "W EY1 T",
    "height": "HH AY1 T", "either": "IY1 DH ER0", "neither": "N IY1 DH ER0",
    "says": "S EH1 Z", "move": "M UW1 V", "lose": "L UW1 Z",
    "whose": "HH UW1 Z", "shoe": "SH UW1", "canoe": "K AH0 N UW1",
    "doesn't": "D AH1 Z AH0 N T", "wasn't": "W AH1 Z AH0 N T",
    "can't": "K AE1 N T", "won't": "W OW1 N T", "isn't": "IH1 Z AH0 N T",
    "aren't": "AA1 R AH0 N T", "i'm": "AY1 M", "i'll": "AY1 L",
    "i've": "AY1 V", "you're": "Y UH1 R", "you'll": "Y UW1 L",
    "we're": "W IH1 R", "we'll": "W IY1 L", "they're": "DH EH1 R",
    "he's": "HH IY1 Z", "she's": "SH IY1 Z", "there's": "DH EH1 R Z",
    "what's": "W AH1 T S", "let's": "L EH1 T S", "that's": "DH AE1 T S",
    "text": "T EH1 K S T", "speech": "S P IY1 CH", "voice": "V OY1 S",
    "language": "L AE1 NG G W AH0 JH", "audio": "AO1 D IY0 OW0",
    "model": "M AA1 D AH0 L", "machine": "M AH0 SH IY1 N",
    "computer": "K AH0 M P Y UW1 T ER0", "quick": "K W IH1 K",
    "brown": "B R AW1 N", "fox": "F AA1 K S", "jumps": "JH AH1 M P S",
    "lazy": "L EY1 Z IY0", "conversion": "K AH0 N V ER1 ZH AH0 N",
    "uses": "Y UW1 S AH0 Z", "phoneme": "F OW1 N IY0 M",
}

VOWELS = "aeiouy"
VOICED_CONS = "bdgjlmnrvwz"
SIBILANT_START = ("ch", "sh", "s", "c", "g", "z", "x", "j")
LONG_U_CONS = ("t", "s", "r", "d", "l", "z", "n", "j", "th", "ch", "sh")
SUFFIXES = ("ely", "ing", "er", "es", "ed", "e")

# Ordered rules per leading letter: (grapheme, left_pattern, right_pattern, phones)
# Patterns are matched outward from the grapheme; '' matches anything.
RULES: list[tuple[str, str, str, str]] = [
    # punctuation-adjacent / whole-grapheme digraphs first (longest match wins
    # is handled by ordering within each first-letter group)
    ("ar", "", " ", "AA R"), ("ar", " ", "", "AA R"), ("ar", "", "", "AA R"),
    ("air", "", "", "EH R"), ("augh", "", "", "AO"), ("aw", "", "", "AO"),
    ("au", "", "", "AO"), ("ai", "", "", "EY"), ("ay", "", "", "EY"),
    ("a", "", "^e ", "EY"), ("a", "", "^^e", "EY"),
    ("a", " ", "^^", "AE"), ("a", "", "^ ", "AE"), ("a", "", "", "AE"),
    ("bb", "", "", "B"), ("b", "", "", "B"),
    ("ch", "", "", "CH"), ("ck", "", "", "K"), ("c", "", "e", "S"),
    ("c", "", "i", "S"), ("c", "", "y", "S"), ("cc", "", "", "K"), ("c", "", "", "K"),
    ("dd", "", "", "D"), ("dge", "", "", "JH"), ("d", "", "", "D"),
    ("ear", "", "", "IH R"), ("ee", "", "", "IY"), ("ea", "", "", "IY"),
    ("eigh", "", "", "EY"), ("ei", "", "", "IY"), ("ey", "", "", "IY"),
    ("ew", "", "", "UW"), ("er", "", " ", "ER"), ("er", "", "", "ER"),
    ("e", "", " ", ""),  # silent final e
    ("e", "", "^e ", "IY"), ("e", "", "", "EH"),
    ("ff", "", "", "F"), ("f", "", "", "F"),
    ("gh", " ", "", "G"), ("gh", "", "", ""), ("gg", "", "", "G"),
    ("g", "", "e ", "JH"), ("g", "", "i", "JH"), ("g", "", "y", "JH"), ("g", "", "", "G"),
    ("h", " ", "#", "HH"), ("h", "", "", ""),
    ("igh", "", "", "AY"), ("ir", "", "", "ER"),
    ("i", "", "^e ", "AY"), ("i", "", "^^e", "AY"),
    ("ie", "", " ", "AY"), ("i", " ", " ", "AY"),
    ("io", "", "n", "AH"), ("i", "", "", "IH"),
    ("j", "", "", "JH"),
    ("kn", " ", "", "N"), ("k", "", "", "K"),
    ("ll", "", "", "L"), ("l", "", "", "L"),
    ("mm", "", "", "M"), ("mb", "", " ", "M"), ("m", "", "", "M"),
    ("nn", "", "", "N"), ("ng", "", " ", "NG"), ("ng", "", "", "NG G"),
    ("nk", "", "", "NG K"), ("n", "", "", "N"),
    ("ough", "", "", "AO"), ("oo", "", "", "UW"), ("oa", "", "", "OW"),
    ("ow", "", " ", "OW"), ("ow", "", "", "AW"), ("ou", "", "", "AW"),
    ("oy", "", "", "OY"), ("oi", "", "", "OY"), ("or", "", "", "AO R"),
    ("o", "", "^e ", "OW"), ("o", "", " ", "OW"), ("o", "", "", "AA"),
    ("ph", "", "", "F"), ("pp", "", "", "P"), ("p", "", "", "P"),
    ("qu", "", "", "K W"), ("q", "", "", "K"),
    ("rr", "", "", "R"), ("r", "", "", "R"),
    ("sh", "", "", "SH"), ("ss", "", "", "S"),
    ("sion", "#", "", "ZH AH N"), ("s", "#", " ", "Z"), ("s", ".", " ", "Z"),
    ("s", "#", "#", "Z"), ("s", "", "", "S"),
    ("tion", "", "", "SH AH N"), ("th", " ", "", "TH"), ("th", "", " ", "TH"),
    ("th", "", "", "DH"), ("tt", "", "", "T"), ("tch", "", "", "CH"), ("t", "", "", "T"),
    ("ur", "", "", "ER"), ("u", "", "^e ", "UW"),
    ("u", "@", "", "UW"), ("u", "", "", "AH"),
    ("v", "", "", "V"),
    ("wh", "", "", "W"), ("wr", " ", "", "R"), ("w", "", "", "W"),
    ("x", " ", "", "Z"), ("x", "", "", "K S"),
    ("y", " ", "", "Y"), ("y", "", " ", "IY"), ("y", "^", " ", "IY"),
    ("y", "", "", "IH"),
    ("zz", "", "", "Z"), ("z", "", "", "Z"),
]

# ARPABET -> IPA (symbols restricted to the reference phoneme table,
# zonos/conditioning.py:146-156).
ARPA_TO_IPA: dict[str, str] = {
    "AA": "ɑ", "AE": "æ", "AH": "ʌ", "AH0": "ə", "AO": "ɔ", "AW": "aʊ",
    "AY": "aɪ", "EH": "ɛ", "ER": "ɜː", "ER0": "ɚ", "EY": "eɪ", "IH": "ɪ",
    "IY": "iː", "OW": "oʊ", "OY": "ɔɪ", "UH": "ʊ", "UW": "uː",
    "B": "b", "CH": "ʧ", "D": "d", "DH": "ð", "F": "f", "G": "ɡ",
    "HH": "h", "JH": "ʤ", "K": "k", "L": "l", "M": "m", "N": "n",
    "NG": "ŋ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ", "T": "t",
    "TH": "θ", "V": "v", "W": "w", "Y": "j", "Z": "z", "ZH": "ʒ",
}

ARPA_VOWELS = {
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH", "IY",
    "OW", "OY", "UH", "UW",
}
