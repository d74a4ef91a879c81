"""Supplementary English pronunciation lexicon (frequency-ranked).

Entries are ARPABET with CMU-convention stress digits, authored from
standard General American pronunciations (the CMU Pronouncing Dictionary's
conventions; pronunciations themselves are dictionary facts).  This extends
the curated core lexicon in ``g2p_rules_en.py`` (which wins on conflicts)
toward dictionary-scale coverage — VERDICT r2 task #6.

Parity surface: the reference gets this coverage from eSpeak-NG's en_list
lexicon (zonos/conditioning.py:212-292 shells out to phonemizer/espeak);
the built-in engine is the zero-dependency fallback path.

Format: one ``word PHONE PHONE ...`` per line; '#' comments; parsed once at
import into ``SUPPLEMENT``.
"""

from __future__ import annotations

_DATA = """
# -- core verbs ------------------------------------------------------------
accept AH0 K S EH1 P T
achieve AH0 CH IY1 V
act AE1 K T
adapt AH0 D AE1 P T
adjust AH0 JH AH1 S T
admit AH0 D M IH1 T
adopt AH0 D AA1 P T
advise AH0 D V AY1 Z
afford AH0 F AO1 R D
agree AH0 G R IY1
aim EY1 M
allow AH0 L AW1
announce AH0 N AW1 N S
annoy AH0 N OY1
apologize AH0 P AA1 L AH0 JH AY2 Z
appear AH0 P IH1 R
apply AH0 P L AY1
appreciate AH0 P R IY1 SH IY0 EY2 T
approach AH0 P R OW1 CH
approve AH0 P R UW1 V
argue AA1 R G Y UW0
arrange AH0 R EY1 N JH
arrest AH0 R EH1 S T
arrive AH0 R AY1 V
assume AH0 S UW1 M
attach AH0 T AE1 CH
attack AH0 T AE1 K
attempt AH0 T EH1 M P T
attend AH0 T EH1 N D
attract AH0 T R AE1 K T
avoid AH0 V OY1 D
bake B EY1 K
base B EY1 S
bear B EH1 R
beat B IY1 T
behave B IH0 HH EY1 V
believe B IH0 L IY1 V
belong B IH0 L AO1 NG
bend B EH1 N D
bet B EH1 T
bind B AY1 N D
bite B AY1 T
blame B L EY1 M
bless B L EH1 S
blow B L OW1
boil B OY1 L
borrow B AA1 R OW0
bother B AA1 DH ER0
bounce B AW1 N S
bow B AW1
breathe B R IY1 DH
breed B R IY1 D
bring B R IH1 NG
broke B R OW1 K
brush B R AH1 SH
build B IH1 L D
burn B ER1 N
burst B ER1 S T
bury B EH1 R IY0
buy B AY1
calculate K AE1 L K Y AH0 L EY2 T
cancel K AE1 N S AH0 L
care K EH1 R
catch K AE1 CH
cause K AA1 Z
celebrate S EH1 L AH0 B R EY2 T
challenge CH AE1 L AH0 N JH
charge CH AA1 R JH
chase CH EY1 S
cheat CH IY1 T
check CH EH1 K
cheer CH IH1 R
chew CH UW1
choose CH UW1 Z
chose CH OW1 Z
claim K L EY1 M
climb K L AY1 M
cling K L IH1 NG
collect K AH0 L EH1 K T
combine K AH0 M B AY1 N
comfort K AH1 M F ER0 T
command K AH0 M AE1 N D
comment K AA1 M EH0 N T
commit K AH0 M IH1 T
communicate K AH0 M Y UW1 N AH0 K EY2 T
compare K AH0 M P EH1 R
compete K AH0 M P IY1 T
complain K AH0 M P L EY1 N
complete K AH0 M P L IY1 T
concentrate K AA1 N S AH0 N T R EY2 T
concern K AH0 N S ER1 N
conclude K AH0 N K L UW1 D
confirm K AH0 N F ER1 M
confuse K AH0 N F Y UW1 Z
connect K AH0 N EH1 K T
consider K AH0 N S IH1 D ER0
consist K AH0 N S IH1 S T
contain K AH0 N T EY1 N
continue K AH0 N T IH1 N Y UW0
contribute K AH0 N T R IH1 B Y UW0 T
control K AH0 N T R OW1 L
convince K AH0 N V IH1 N S
cook K UH1 K
copy K AA1 P IY0
cost K AA1 S T
count K AW1 N T
cover K AH1 V ER0
crash K R AE1 SH
crawl K R AO1 L
create K R IY0 EY1 T
cry K R AY1
cure K Y UH1 R
dance D AE1 N S
dare D EH1 R
deal D IY1 L
decide D IH0 S AY1 D
declare D IH0 K L EH1 R
defeat D IH0 F IY1 T
defend D IH0 F EH1 N D
define D IH0 F AY1 N
delay D IH0 L EY1
deliver D IH0 L IH1 V ER0
demand D IH0 M AE1 N D
deny D IH0 N AY1
depend D IH0 P EH1 N D
describe D IH0 S K R AY1 B
deserve D IH0 Z ER1 V
design D IH0 Z AY1 N
desire D IH0 Z AY1 ER0
destroy D IH0 S T R OY1
develop D IH0 V EH1 L AH0 P
die D AY1
dig D IH1 G
disagree D IH2 S AH0 G R IY1
disappear D IH2 S AH0 P IH1 R
discover D IH0 S K AH1 V ER0
discuss D IH0 S K AH1 S
dislike D IH0 S L AY1 K
divide D IH0 V AY1 D
doubt D AW1 T
drag D R AE1 G
draw D R AO1
dream D R IY1 M
dress D R EH1 S
drink D R IH1 NG K
drive D R AY1 V
drop D R AA1 P
drown D R AW1 N
dry D R AY1
earn ER1 N
eat IY1 T
edit EH1 D AH0 T
educate EH1 JH AH0 K EY2 T
elect IH0 L EH1 K T
embarrass IH0 M B EH1 R AH0 S
employ EH0 M P L OY1
enable EH0 N EY1 B AH0 L
encourage EH0 N K ER1 IH0 JH
engage EH0 N G EY1 JH
enjoy EH0 N JH OY1
enter EH1 N T ER0
entertain EH2 N T ER0 T EY1 N
escape IH0 S K EY1 P
establish IH0 S T AE1 B L IH0 SH
estimate EH1 S T AH0 M EY2 T
examine IH0 G Z AE1 M AH0 N
exist IH0 G Z IH1 S T
expand IH0 K S P AE1 N D
expect IH0 K S P EH1 K T
explain IH0 K S P L EY1 N
explore IH0 K S P L AO1 R
express IH0 K S P R EH1 S
extend IH0 K S T EH1 N D
fail F EY1 L
fasten F AE1 S AH0 N
fear F IH1 R
feed F IY1 D
feel F IY1 L
fight F AY1 T
fill F IH1 L
fit F IH1 T
fix F IH1 K S
flee F L IY1
float F L OW1 T
flow F L OW1
fly F L AY1
fold F OW1 L D
forbid F ER0 B IH1 D
force F AO1 R S
forget F ER0 G EH1 T
forgive F ER0 G IH1 V
freeze F R IY1 Z
fry F R AY1
gain G EY1 N
gather G AE1 DH ER0
glance G L AE1 N S
grab G R AE1 B
greet G R IY1 T
grow G R OW1
guarantee G EH2 R AH0 N T IY1
guard G AA1 R D
guess G EH1 S
guide G AY1 D
handle HH AE1 N D AH0 L
hang HH AE1 NG
happen HH AE1 P AH0 N
hate HH EY1 T
heal HH IY1 L
hide HH AY1 D
hire HH AY1 ER0
hit HH IH1 T
hold HH OW1 L D
hope HH OW1 P
hug HH AH1 G
hunt HH AH1 N T
hurry HH ER1 IY0
hurt HH ER1 T
identify AY0 D EH1 N T AH0 F AY2
ignore IH0 G N AO1 R
imagine IH0 M AE1 JH AH0 N
improve IH0 M P R UW1 V
include IH0 N K L UW1 D
increase IH0 N K R IY1 S
indicate IH1 N D AH0 K EY2 T
inform IH0 N F AO1 R M
insist IH0 N S IH1 S T
intend IH0 N T EH1 N D
introduce IH2 N T R AH0 D UW1 S
invent IH0 N V EH1 N T
invest IH0 N V EH1 S T
invite IH0 N V AY1 T
involve IH0 N V AA1 L V
join JH OY1 N
jump JH AH1 M P
keep K IY1 P
kick K IH1 K
kill K IH1 L
kiss K IH1 S
knock N AA1 K
lack L AE1 K
land L AE1 N D
last L AE1 S T
laugh L AE1 F
lay L EY1
lead L IY1 D
lean L IY1 N
leave L IY1 V
lend L EH1 N D
lie L AY1
lift L IH1 F T
listen L IH1 S AH0 N
lock L AA1 K
lose L UW1 Z
love L AH1 V
maintain M EY0 N T EY1 N
manage M AE1 N IH0 JH
marry M EH1 R IY0
matter M AE1 T ER0
measure M EH1 ZH ER0
meet M IY1 T
melt M EH1 L T
mention M EH1 N SH AH0 N
mind M AY1 N D
miss M IH1 S
mix M IH1 K S
move M UW1 V
need N IY1 D
notice N OW1 T AH0 S
obey OW0 B EY1
observe AH0 B Z ER1 V
obtain AH0 B T EY1 N
occur AH0 K ER1
offer AO1 F ER0
open OW1 P AH0 N
order AO1 R D ER0
organize AO1 R G AH0 N AY2 Z
owe OW1
own OW1 N
pack P AE1 K
paint P EY1 N T
pass P AE1 S
pay P EY1
perform P ER0 F AO1 R M
permit P ER0 M IH1 T
persuade P ER0 S W EY1 D
pick P IH1 K
plan P L AE1 N
plant P L AE1 N T
play P L EY1
point P OY1 N T
postpone P OW0 S T P OW1 N
pour P AO1 R
practice P R AE1 K T AH0 S
pray P R EY1
prefer P R IH0 F ER1
prepare P R IY0 P EH1 R
present P R IH0 Z EH1 N T
press P R EH1 S
pretend P R IY0 T EH1 N D
prevent P R IH0 V EH1 N T
print P R IH1 N T
produce P R AH0 D UW1 S
promise P R AA1 M AH0 S
protect P R AH0 T EH1 K T
prove P R UW1 V
provide P R AH0 V AY1 D
publish P AH1 B L IH0 SH
pull P UH1 L
punish P AH1 N IH0 SH
push P UH1 SH
put P UH1 T
raise R EY1 Z
reach R IY1 CH
react R IY0 AE1 K T
realize R IY1 AH0 L AY2 Z
receive R IH0 S IY1 V
recognize R EH1 K AH0 G N AY2 Z
recommend R EH2 K AH0 M EH1 N D
record R IH0 K AO1 R D
reduce R IH0 D UW1 S
refer R IH0 F ER1
reflect R IH0 F L EH1 K T
refuse R IH0 F Y UW1 Z
regret R IH0 G R EH1 T
relate R IH0 L EY1 T
relax R IH0 L AE1 K S
release R IH0 L IY1 S
rely R IH0 L AY1
remain R IH0 M EY1 N
remember R IH0 M EH1 M B ER0
remind R IY0 M AY1 N D
remove R IY0 M UW1 V
rent R EH1 N T
repair R IH0 P EH1 R
repeat R IH0 P IY1 T
replace R IH0 P L EY1 S
reply R IH0 P L AY1
report R IH0 P AO1 R T
represent R EH2 P R IH0 Z EH1 N T
request R IH0 K W EH1 S T
require R IY0 K W AY1 ER0
rescue R EH1 S K Y UW0
respect R IH0 S P EH1 K T
respond R IH0 S P AA1 N D
rest R EH1 S T
result R IH0 Z AH1 L T
retire R IH0 T AY1 ER0
return R IH0 T ER1 N
reveal R IH0 V IY1 L
ride R AY1 D
ring R IH1 NG
rise R AY1 Z
risk R IH1 S K
roll R OW1 L
rub R AH1 B
ruin R UW1 AH0 N
rush R AH1 SH
satisfy S AE1 T AH0 S F AY2
save S EY1 V
scare S K EH1 R
score S K AO1 R
scratch S K R AE1 CH
scream S K R IY1 M
search S ER1 CH
seek S IY1 K
seem S IY1 M
select S AH0 L EH1 K T
sell S EH1 L
send S EH1 N D
separate S EH1 P ER0 EY2 T
serve S ER1 V
settle S EH1 T AH0 L
shake SH EY1 K
share SH EH1 R
shine SH AY1 N
shoot SH UW1 T
shout SH AW1 T
shut SH AH1 T
sigh S AY1
sing S IH1 NG
sink S IH1 NG K
sit S IH1 T
sleep S L IY1 P
slide S L AY1 D
slip S L IH1 P
smell S M EH1 L
smile S M AY1 L
solve S AA1 L V
speak S P IY1 K
spell S P EH1 L
spend S P EH1 N D
spill S P IH1 L
spin S P IH1 N
split S P L IH1 T
spread S P R EH1 D
squeeze S K W IY1 Z
stand S T AE1 N D
stare S T EH1 R
start S T AA1 R T
stay S T EY1
steal S T IY1 L
stick S T IH1 K
sting S T IH1 NG
stir S T ER1
stop S T AA1 P
stretch S T R EH1 CH
strike S T R AY1 K
struggle S T R AH1 G AH0 L
study S T AH1 D IY0
succeed S AH0 K S IY1 D
suffer S AH1 F ER0
suggest S AH0 G JH EH1 S T
supply S AH0 P L AY1
support S AH0 P AO1 R T
suppose S AH0 P OW1 Z
surround S ER0 AW1 N D
survive S ER0 V AY1 V
swear S W EH1 R
sweep S W IY1 P
swim S W IH1 M
swing S W IH1 NG
take T EY1 K
talk T AO1 K
taste T EY1 S T
teach T IY1 CH
tear T EH1 R
tell T EH1 L
tend T EH1 N D
thank TH AE1 NG K
throw TH R OW1
tie T AY1
touch T AH1 CH
train T R EY1 N
travel T R AE1 V AH0 L
treat T R IY1 T
trust T R AH1 S T
try T R AY1
turn T ER1 N
understand AH2 N D ER0 S T AE1 N D
unite Y UW0 N AY1 T
urge ER1 JH
vary V EH1 R IY0
visit V IH1 Z AH0 T
vote V OW1 T
wait W EY1 T
wake W EY1 K
walk W AO1 K
wander W AA1 N D ER0
warn W AO1 R N
wash W AA1 SH
waste W EY1 S T
watch W AA1 CH
wave W EY1 V
wear W EH1 R
weigh W EY1
welcome W EH1 L K AH0 M
win W IH1 N
wipe W AY1 P
wish W IH1 SH
wonder W AH1 N D ER0
worry W ER1 IY0
wrap R AE1 P
yell Y EH1 L
# -- irregular past/participle forms --------------------------------------
ate EY1 T
became B IH0 K EY1 M
begun B IH0 G AH1 N
bent B EH1 N T
bit B IH1 T
bitten B IH1 T AH0 N
blew B L UW1
blown B L OW1 N
broken B R OW1 K AH0 N
brought B R AO1 T
built B IH1 L T
burnt B ER1 N T
caught K AO1 T
chosen CH OW1 Z AH0 N
came K EY1 M
dealt D EH1 L T
done D AH1 N
drank D R AE1 NG K
drawn D R AO1 N
dreamt D R EH1 M T
drew D R UW1
driven D R IH1 V AH0 N
drove D R OW1 V
drunk D R AH1 NG K
eaten IY1 T AH0 N
fallen F AO1 L AH0 N
fell F EH1 L
felt F EH1 L T
flew F L UW1
flown F L OW1 N
forgot F ER0 G AA1 T
forgotten F ER0 G AA1 T AH0 N
fought F AO1 T
froze F R OW1 Z
frozen F R OW1 Z AH0 N
gave G EY1 V
given G IH1 V AH0 N
gone G AO1 N
grew G R UW1
grown G R OW1 N
heard HH ER1 D
held HH EH1 L D
hidden HH IH1 D AH0 N
hung HH AH1 NG
kept K EH1 P T
knew N UW1
known N OW1 N
laid L EY1 D
lain L EY1 N
led L EH1 D
left L EH1 F T
lent L EH1 N T
lost L AO1 S T
meant M EH1 N T
met M EH1 T
mistaken M IH0 S T EY1 K AH0 N
paid P EY1 D
ran R AE1 N
rang R AE1 NG
ridden R IH1 D AH0 N
risen R IH1 Z AH0 N
rode R OW1 D
rose R OW1 Z
sang S AE1 NG
sat S AE1 T
saw S AO1
seen S IY1 N
sent S EH1 N T
shaken SH EY1 K AH0 N
shone SH OW1 N
shot SH AA1 T
shown SH OW1 N
slept S L EH1 P T
sold S OW1 L D
sought S AO1 T
spent S P EH1 N T
spoke S P OW1 K
spoken S P OW1 K AH0 N
stood S T UH1 D
stolen S T OW1 L AH0 N
stole S T OW1 L
struck S T R AH1 K
stuck S T AH1 K
sung S AH1 NG
swam S W AE1 M
swept S W EH1 P T
swore S W AO1 R
sworn S W AO1 R N
taken T EY1 K AH0 N
taught T AO1 T
thought TH AO1 T
threw TH R UW1
thrown TH R OW1 N
told T OW1 L D
took T UH1 K
torn T AO1 R N
understood AH2 N D ER0 S T UH1 D
went W EH1 N T
wept W EH1 P T
woke W OW1 K
won W AH1 N
wore W AO1 R
worn W AO1 R N
wound W UW1 N D
written R IH1 T AH0 N
wrote R OW1 T
# -- common nouns ----------------------------------------------------------
ability AH0 B IH1 L AH0 T IY0
accident AE1 K S AH0 D AH0 N T
account AH0 K AW1 N T
action AE1 K SH AH0 N
activity AE0 K T IH1 V AH0 T IY0
address AH0 D R EH1 S
administration AH0 D M IH2 N AH0 S T R EY1 SH AH0 N
adult AH0 D AH1 L T
advantage AH0 D V AE1 N T IH0 JH
adventure AH0 D V EH1 N CH ER0
advertisement AE2 D V ER0 T AY1 Z M AH0 N T
advice AH0 D V AY1 S
afternoon AE2 F T ER0 N UW1 N
age EY1 JH
agency EY1 JH AH0 N S IY0
agreement AH0 G R IY1 M AH0 N T
airport EH1 R P AO2 R T
alarm AH0 L AA1 R M
album AE1 L B AH0 M
alcohol AE1 L K AH0 HH AO2 L
ambulance AE1 M B Y AH0 L AH0 N S
amount AH0 M AW1 N T
analysis AH0 N AE1 L AH0 S AH0 S
angle AE1 NG G AH0 L
ankle AE1 NG K AH0 L
apartment AH0 P AA1 R T M AH0 N T
appearance AH0 P IH1 R AH0 N S
apple AE1 P AH0 L
application AE2 P L AH0 K EY1 SH AH0 N
appointment AH0 P OY1 N T M AH0 N T
argument AA1 R G Y AH0 M AH0 N T
arm AA1 R M
army AA1 R M IY0
arrival AH0 R AY1 V AH0 L
article AA1 R T AH0 K AH0 L
artist AA1 R T AH0 S T
aspect AE1 S P EH2 K T
assignment AH0 S AY1 N M AH0 N T
assistant AH0 S IH1 S T AH0 N T
association AH0 S OW2 S IY0 EY1 SH AH0 N
atmosphere AE1 T M AH0 S F IH2 R
attention AH0 T EH1 N SH AH0 N
attitude AE1 T AH0 T UW2 D
audience AA1 D IY0 AH0 N S
author AO1 TH ER0
authority AH0 TH AO1 R AH0 T IY0
average AE1 V R IH0 JH
award AH0 W AO1 R D
baby B EY1 B IY0
background B AE1 K G R AW2 N D
bag B AE1 G
balance B AE1 L AH0 N S
ball B AO1 L
banana B AH0 N AE1 N AH0
band B AE1 N D
bank B AE1 NG K
bar B AA1 R
baseball B EY1 S B AO2 L
basis B EY1 S AH0 S
basket B AE1 S K AH0 T
bath B AE1 TH
bathroom B AE1 TH R UW2 M
battery B AE1 T ER0 IY0
battle B AE1 T AH0 L
beach B IY1 CH
bean B IY1 N
beauty B Y UW1 T IY0
bed B EH1 D
bedroom B EH1 D R UW2 M
beer B IH1 R
beginning B IH0 G IH1 N IH0 NG
behavior B IH0 HH EY1 V Y ER0
bell B EH1 L
belt B EH1 L T
benefit B EH1 N AH0 F IH0 T
bicycle B AY1 S IH0 K AH0 L
bill B IH1 L
birth B ER1 TH
birthday B ER1 TH D EY2
bit B IH1 T
blanket B L AE1 NG K AH0 T
block B L AA1 K
blood B L AH1 D
board B AO1 R D
boat B OW1 T
bone B OW1 N
bonus B OW1 N AH0 S
border B AO1 R D ER0
boss B AO1 S
bottle B AA1 T AH0 L
bottom B AA1 T AH0 M
bowl B OW1 L
box B AA1 K S
brain B R EY1 N
branch B R AE1 N CH
bread B R EH1 D
breakfast B R EH1 K F AH0 S T
breath B R EH1 TH
brick B R IH1 K
bridge B R IH1 JH
brother B R AH1 DH ER0
budget B AH1 JH IH0 T
building B IH1 L D IH0 NG
bus B AH1 S
business B IH1 Z N AH0 S
butter B AH1 T ER0
button B AH1 T AH0 N
cabinet K AE1 B AH0 N AH0 T
cable K EY1 B AH0 L
cake K EY1 K
camera K AE1 M ER0 AH0
camp K AE1 M P
campaign K AE0 M P EY1 N
cancer K AE1 N S ER0
candidate K AE1 N D AH0 D EY2 T
candle K AE1 N D AH0 L
candy K AE1 N D IY0
capital K AE1 P AH0 T AH0 L
captain K AE1 P T AH0 N
car K AA1 R
card K AA1 R D
career K ER0 IH1 R
carpet K AA1 R P AH0 T
carrot K EH1 R AH0 T
case K EY1 S
cash K AE1 SH
cat K AE1 T
category K AE1 T AH0 G AO2 R IY0
ceiling S IY1 L IH0 NG
cell S EH1 L
center S EH1 N T ER0
century S EH1 N CH ER0 IY0
ceremony S EH1 R AH0 M OW2 N IY0
chain CH EY1 N
chair CH EH1 R
championship CH AE1 M P IY0 AH0 N SH IH2 P
chance CH AE1 N S
change CH EY1 N JH
channel CH AE1 N AH0 L
chapter CH AE1 P T ER0
character K EH1 R IH0 K T ER0
cheese CH IY1 Z
chemistry K EH1 M AH0 S T R IY0
chest CH EH1 S T
chicken CH IH1 K AH0 N
chief CH IY1 F
child CH AY1 L D
childhood CH AY1 L D HH UH2 D
chocolate CH AO1 K L AH0 T
choice CH OY1 S
church CH ER1 CH
circle S ER1 K AH0 L
citizen S IH1 T AH0 Z AH0 N
city S IH1 T IY0
class K L AE1 S
classroom K L AE1 S R UW2 M
client K L AY1 AH0 N T
climate K L AY1 M AH0 T
clock K L AA1 K
cloth K L AO1 TH
clothes K L OW1 DH Z
cloud K L AW1 D
club K L AH1 B
coach K OW1 CH
coast K OW1 S T
coat K OW1 T
code K OW1 D
coffee K AA1 F IY0
collection K AH0 L EH1 K SH AH0 N
college K AA1 L IH0 JH
color K AH1 L ER0
column K AA1 L AH0 M
combination K AA2 M B AH0 N EY1 SH AH0 N
comfort K AH1 M F ER0 T
committee K AH0 M IH1 T IY0
community K AH0 M Y UW1 N AH0 T IY0
company K AH1 M P AH0 N IY0
comparison K AH0 M P EH1 R AH0 S AH0 N
competition K AA2 M P AH0 T IH1 SH AH0 N
computer K AH0 M P Y UW1 T ER0
concept K AA1 N S EH0 P T
concert K AA1 N S ER0 T
conclusion K AH0 N K L UW1 ZH AH0 N
condition K AH0 N D IH1 SH AH0 N
conference K AA1 N F ER0 AH0 N S
confidence K AA1 N F AH0 D AH0 N S
conflict K AA1 N F L IH0 K T
connection K AH0 N EH1 K SH AH0 N
consequence K AA1 N S AH0 K W AH0 N S
construction K AH0 N S T R AH1 K SH AH0 N
contact K AA1 N T AE2 K T
content K AA1 N T EH0 N T
contest K AA1 N T EH0 S T
context K AA1 N T EH0 K S T
contract K AA1 N T R AE2 K T
contrast K AA1 N T R AE0 S T
conversation K AA2 N V ER0 S EY1 SH AH0 N
corner K AO1 R N ER0
cost K AA1 S T
cotton K AA1 T AH0 N
couch K AW1 CH
country K AH1 N T R IY0
county K AW1 N T IY0
couple K AH1 P AH0 L
courage K ER1 IH0 JH
course K AO1 R S
court K AO1 R T
cousin K AH1 Z AH0 N
cow K AW1
cream K R IY1 M
credit K R EH1 D AH0 T
crew K R UW1
crime K R AY1 M
crisis K R AY1 S AH0 S
criticism K R IH1 T IH0 S IH2 Z AH0 M
crowd K R AW1 D
culture K AH1 L CH ER0
cup K AH1 P
currency K ER1 AH0 N S IY0
customer K AH1 S T AH0 M ER0
cycle S AY1 K AH0 L
damage D AE1 M AH0 JH
danger D EY1 N JH ER0
data D EY1 T AH0
database D EY1 T AH0 B EY2 S
date D EY1 T
daughter D AO1 T ER0
dawn D AO1 N
death D EH1 TH
debate D IH0 B EY1 T
debt D EH1 T
decade D EH1 K EY0 D
decision D IH0 S IH1 ZH AH0 N
defense D IH0 F EH1 N S
definition D EH2 F AH0 N IH1 SH AH0 N
degree D IH0 G R IY1
delivery D IH0 L IH1 V ER0 IY0
demand D IH0 M AE1 N D
democracy D IH0 M AA1 K R AH0 S IY0
department D IH0 P AA1 R T M AH0 N T
departure D IH0 P AA1 R CH ER0
deposit D AH0 P AA1 Z AH0 T
depression D IH0 P R EH1 SH AH0 N
depth D EH1 P TH
description D IH0 S K R IH1 P SH AH0 N
desert D EH1 Z ER0 T
desk D EH1 S K
dessert D IH0 Z ER1 T
detail D IH0 T EY1 L
device D IH0 V AY1 S
diamond D AY1 M AH0 N D
diet D AY1 AH0 T
difference D IH1 F ER0 AH0 N S
difficulty D IH1 F AH0 K AH2 L T IY0
dinner D IH1 N ER0
direction D ER0 EH1 K SH AH0 N
director D ER0 EH1 K T ER0
dirt D ER1 T
disaster D IH0 Z AE1 S T ER0
discipline D IH1 S AH0 P L AH0 N
discussion D IH0 S K AH1 SH AH0 N
disease D IH0 Z IY1 Z
dish D IH1 SH
distance D IH1 S T AH0 N S
distribution D IH2 S T R AH0 B Y UW1 SH AH0 N
district D IH1 S T R IH0 K T
doctor D AA1 K T ER0
document D AA1 K Y AH0 M EH0 N T
dog D AA1 G
door D AO1 R
dozen D AH1 Z AH0 N
drama D R AA1 M AH0
drawer D R AO1 R
dust D AH1 S T
duty D UW1 T IY0
ear IH1 R
earthquake ER1 TH K W EY2 K
economics EH2 K AH0 N AA1 M IH0 K S
economy IH0 K AA1 N AH0 M IY0
edge EH1 JH
editor EH1 D AH0 T ER0
education EH2 JH AH0 K EY1 SH AH0 N
effect IH0 F EH1 K T
efficiency IH0 F IH1 SH AH0 N S IY0
effort EH1 F ER0 T
egg EH1 G
election IH0 L EH1 K SH AH0 N
electricity IH0 L EH2 K T R IH1 S AH0 T IY0
elevator EH1 L AH0 V EY2 T ER0
emergency IH0 M ER1 JH AH0 N S IY0
emotion IH0 M OW1 SH AH0 N
emphasis EH1 M F AH0 S AH0 S
employee EH0 M P L OY1 IY0
employer EH0 M P L OY1 ER0
employment EH0 M P L OY1 M AH0 N T
energy EH1 N ER0 JH IY0
engine EH1 N JH AH0 N
engineer EH2 N JH AH0 N IH1 R
engineering EH2 N JH AH0 N IH1 R IH0 NG
entrance EH1 N T R AH0 N S
entry EH1 N T R IY0
environment IH0 N V AY1 R AH0 N M AH0 N T
equipment IH0 K W IH1 P M AH0 N T
error EH1 R ER0
establishment IH0 S T AE1 B L IH0 SH M AH0 N T
estate IH0 S T EY1 T
evening IY1 V N IH0 NG
event IH0 V EH1 N T
evidence EH1 V AH0 D AH0 N S
exam IH0 G Z AE1 M
examination IH0 G Z AE2 M AH0 N EY1 SH AH0 N
example IH0 G Z AE1 M P AH0 L
exchange IH0 K S CH EY1 N JH
excitement IH0 K S AY1 T M AH0 N T
excuse IH0 K S K Y UW1 S
exercise EH1 K S ER0 S AY2 Z
exit EH1 G Z IH0 T
experience IH0 K S P IH1 R IY0 AH0 N S
experiment IH0 K S P EH1 R AH0 M AH0 N T
expert EH1 K S P ER0 T
explanation EH2 K S P L AH0 N EY1 SH AH0 N
expression IH0 K S P R EH1 SH AH0 N
extent IH0 K S T EH1 N T
eye AY1
fact F AE1 K T
factor F AE1 K T ER0
factory F AE1 K T ER0 IY0
failure F EY1 L Y ER0
faith F EY1 TH
fan F AE1 N
farm F AA1 R M
farmer F AA1 R M ER0
fashion F AE1 SH AH0 N
fat F AE1 T
fault F AO1 L T
fear F IH1 R
feature F IY1 CH ER0
fee F IY1
feedback F IY1 D B AE2 K
feeling F IY1 L IH0 NG
fiction F IH1 K SH AH0 N
field F IY1 L D
figure F IH1 G Y ER0
film F IH1 L M
finance F AH0 N AE1 N S
finger F IH1 NG G ER0
fire F AY1 ER0
fish F IH1 SH
flag F L AE1 G
flavor F L EY1 V ER0
flight F L AY1 T
floor F L AO1 R
flour F L AW1 ER0
flower F L AW1 ER0
focus F OW1 K AH0 S
food F UW1 D
foot F UH1 T
football F UH1 T B AO2 L
forest F AO1 R AH0 S T
fortune F AO1 R CH AH0 N
foundation F AW0 N D EY1 SH AH0 N
frame F R EY1 M
freedom F R IY1 D AH0 M
friend F R EH1 N D
friendship F R EH1 N D SH IH2 P
fruit F R UW1 T
fuel F Y UW1 AH0 L
fun F AH1 N
function F AH1 NG K SH AH0 N
fund F AH1 N D
furniture F ER1 N IH0 CH ER0
future F Y UW1 CH ER0
game G EY1 M
gap G AE1 P
garage G ER0 AA1 ZH
garden G AA1 R D AH0 N
garlic G AA1 R L IH0 K
gas G AE1 S
gate G EY1 T
gear G IH1 R
gene JH IY1 N
generation JH EH2 N ER0 EY1 SH AH0 N
gift G IH1 F T
girl G ER1 L
glass G L AE1 S
goal G OW1 L
gold G OW1 L D
government G AH1 V ER0 M AH0 N T
grade G R EY1 D
grain G R EY1 N
grandfather G R AE1 N D F AA2 DH ER0
grandmother G R AE1 N D M AH2 DH ER0
grass G R AE1 S
ground G R AW1 N D
growth G R OW1 TH
guest G EH1 S T
guitar G IH0 T AA1 R
gun G AH1 N
guy G AY1
habit HH AE1 B AH0 T
hair HH EH1 R
half HH AE1 F
hall HH AO1 L
hand HH AE1 N D
harm HH AA1 R M
hat HH AE1 T
health HH EH1 L TH
heart HH AA1 R T
heat HH IY1 T
height HH AY1 T
hell HH EH1 L
hero HH IH1 R OW0
highway HH AY1 W EY2
hill HH IH1 L
history HH IH1 S T ER0 IY0
hole HH OW1 L
holiday HH AA1 L AH0 D EY2
homework HH OW1 M W ER2 K
honey HH AH1 N IY0
honor AA1 N ER0
horror HH AO1 R ER0
horse HH AO1 R S
hospital HH AA1 S P IH0 T AH0 L
hotel HH OW0 T EH1 L
hour AW1 ER0
house HH AW1 S
housing HH AW1 Z IH0 NG
human HH Y UW1 M AH0 N
humor HH Y UW1 M ER0
husband HH AH1 Z B AH0 N D
ice AY1 S
idea AY0 D IY1 AH0
image IH1 M IH0 JH
imagination IH0 M AE2 JH AH0 N EY1 SH AH0 N
impact IH1 M P AE0 K T
importance IH0 M P AO1 R T AH0 N S
impression IH0 M P R EH1 SH AH0 N
improvement IH0 M P R UW1 V M AH0 N T
incident IH1 N S AH0 D AH0 N T
income IH1 N K AH2 M
independence IH2 N D IH0 P EH1 N D AH0 N S
industry IH1 N D AH0 S T R IY0
inflation IH0 N F L EY1 SH AH0 N
information IH2 N F ER0 M EY1 SH AH0 N
ingredient IH0 N G R IY1 D IY0 AH0 N T
initiative IH0 N IH1 SH AH0 T IH0 V
injury IH1 N JH ER0 IY0
insect IH1 N S EH2 K T
inside IH0 N S AY1 D
inspection IH0 N S P EH1 K SH AH0 N
inspector IH0 N S P EH1 K T ER0
instance IH1 N S T AH0 N S
instruction IH0 N S T R AH1 K SH AH0 N
instrument IH1 N S T R AH0 M AH0 N T
insurance IH0 N SH UH1 R AH0 N S
intention IH0 N T EH1 N CH AH0 N
interaction IH2 N T ER0 AE1 K SH AH0 N
interest IH1 N T R AH0 S T
internet IH1 N T ER0 N EH2 T
interview IH1 N T ER0 V Y UW2
introduction IH2 N T R AH0 D AH1 K SH AH0 N
investment IH0 N V EH1 S T M AH0 N T
iron AY1 ER0 N
island AY1 L AH0 N D
issue IH1 SH UW0
item AY1 T AH0 M
jacket JH AE1 K AH0 T
job JH AA1 B
joint JH OY1 N T
joke JH OW1 K
journey JH ER1 N IY0
joy JH OY1
judge JH AH1 JH
judgment JH AH1 JH M AH0 N T
juice JH UW1 S
jury JH UH1 R IY0
justice JH AH1 S T AH0 S
key K IY1
keyboard K IY1 B AO2 R D
kid K IH1 D
king K IH1 NG
kitchen K IH1 CH AH0 N
knee N IY1
knife N AY1 F
knowledge N AA1 L IH0 JH
lab L AE1 B
label L EY1 B AH0 L
labor L EY1 B ER0
ladder L AE1 D ER0
lady L EY1 D IY0
lake L EY1 K
lamp L AE1 M P
language L AE1 NG G W AH0 JH
law L AO1
lawyer L AO1 Y ER0
layer L EY1 ER0
leader L IY1 D ER0
leadership L IY1 D ER0 SH IH2 P
league L IY1 G
lecture L EH1 K CH ER0
leg L EH1 G
lemon L EH1 M AH0 N
length L EH1 NG K TH
lesson L EH1 S AH0 N
letter L EH1 T ER0
level L EH1 V AH0 L
library L AY1 B R EH2 R IY0
life L AY1 F
limit L IH1 M AH0 T
link L IH1 NG K
lip L IH1 P
list L IH1 S T
literature L IH1 T ER0 AH0 CH ER0
load L OW1 D
loan L OW1 N
location L OW0 K EY1 SH AH0 N
loss L AO1 S
lunch L AH1 N CH
machine M AH0 SH IY1 N
magazine M AE1 G AH0 Z IY2 N
mail M EY1 L
mall M AO1 L
management M AE1 N IH0 JH M AH0 N T
manager M AE1 N IH0 JH ER0
manner M AE1 N ER0
map M AE1 P
market M AA1 R K AH0 T
marketing M AA1 R K AH0 T IH0 NG
marriage M EH1 R IH0 JH
match M AE1 CH
material M AH0 T IH1 R IY0 AH0 L
math M AE1 TH
meal M IY1 L
meaning M IY1 N IH0 NG
meat M IY1 T
media M IY1 D IY0 AH0
medicine M EH1 D AH0 S AH0 N
meeting M IY1 T IH0 NG
member M EH1 M B ER0
membership M EH1 M B ER0 SH IH2 P
memory M EH1 M ER0 IY0
message M EH1 S IH0 JH
metal M EH1 T AH0 L
method M EH1 TH AH0 D
midnight M IH1 D N AY2 T
mile M AY1 L
milk M IH1 L K
million M IH1 L Y AH0 N
mind M AY1 N D
minute M IH1 N AH0 T
mirror M IH1 R ER0
mission M IH1 SH AH0 N
mistake M IH0 S T EY1 K
mixture M IH1 K S CH ER0
mode M OW1 D
model M AA1 D AH0 L
mom M AA1 M
moment M OW1 M AH0 N T
money M AH1 N IY0
monitor M AA1 N AH0 T ER0
month M AH1 N TH
mood M UW1 D
morning M AO1 R N IH0 NG
mother M AH1 DH ER0
motor M OW1 T ER0
mountain M AW1 N T AH0 N
mouse M AW1 S
mouth M AW1 TH
movie M UW1 V IY0
mud M AH1 D
muscle M AH1 S AH0 L
museum M Y UW0 Z IY1 AH0 M
music M Y UW1 Z IH0 K
nation N EY1 SH AH0 N
nature N EY1 CH ER0
neck N EH1 K
needle N IY1 D AH0 L
neighbor N EY1 B ER0
neighborhood N EY1 B ER0 HH UH2 D
nerve N ER1 V
network N EH1 T W ER2 K
news N UW1 Z
newspaper N UW1 Z P EY2 P ER0
night N AY1 T
nobody N OW1 B AA2 D IY0
noise N OY1 Z
noon N UW1 N
nose N OW1 Z
note N OW1 T
notebook N OW1 T B UH2 K
nothing N AH1 TH IH0 NG
novel N AA1 V AH0 L
number N AH1 M B ER0
nurse N ER1 S
object AA1 B JH EH0 K T
objective AH0 B JH EH1 K T IH0 V
obligation AA2 B L AH0 G EY1 SH AH0 N
occasion AH0 K EY1 ZH AH0 N
ocean OW1 SH AH0 N
office AO1 F AH0 S
officer AO1 F AH0 S ER0
official AH0 F IH1 SH AH0 L
oil OY1 L
onion AH1 N Y AH0 N
operation AA2 P ER0 EY1 SH AH0 N
opinion AH0 P IH1 N Y AH0 N
opportunity AA2 P ER0 T UW1 N AH0 T IY0
option AA1 P SH AH0 N
orange AO1 R AH0 N JH
organization AO2 R G AH0 N AH0 Z EY1 SH AH0 N
outcome AW1 T K AH2 M
outside AW1 T S AY1 D
oven AH1 V AH0 N
owner OW1 N ER0
oxygen AA1 K S AH0 JH AH0 N
pace P EY1 S
package P AE1 K IH0 JH
page P EY1 JH
pain P EY1 N
painting P EY1 N T IH0 NG
pair P EH1 R
pan P AE1 N
panel P AE1 N AH0 L
pants P AE1 N T S
paper P EY1 P ER0
parent P EH1 R AH0 N T
park P AA1 R K
partner P AA1 R T N ER0
party P AA1 R T IY0
passage P AE1 S IH0 JH
passenger P AE1 S AH0 N JH ER0
passion P AE1 SH AH0 N
past P AE1 S T
path P AE1 TH
patience P EY1 SH AH0 N S
patient P EY1 SH AH0 N T
pattern P AE1 T ER0 N
pause P AO1 Z
payment P EY1 M AH0 N T
peace P IY1 S
pen P EH1 N
penalty P EH1 N AH0 L T IY0
pencil P EH1 N S AH0 L
pension P EH1 N SH AH0 N
percentage P ER0 S EH1 N T IH0 JH
performance P ER0 F AO1 R M AH0 N S
period P IH1 R IY0 AH0 D
permission P ER0 M IH1 SH AH0 N
person P ER1 S AH0 N
personality P ER2 S AH0 N AE1 L AH0 T IY0
perspective P ER0 S P EH1 K T IH0 V
phase F EY1 Z
phone F OW1 N
photo F OW1 T OW2
phrase F R EY1 Z
physics F IH1 Z IH0 K S
piano P IY0 AE1 N OW0
picture P IH1 K CH ER0
piece P IY1 S
pin P IH1 N
pipe P AY1 P
pitch P IH1 CH
pizza P IY1 T S AH0
plane P L EY1 N
planet P L AE1 N AH0 T
plastic P L AE1 S T IH0 K
plate P L EY1 T
platform P L AE1 T F AO2 R M
pleasure P L EH1 ZH ER0
plenty P L EH1 N T IY0
pocket P AA1 K AH0 T
poem P OW1 AH0 M
poet P OW1 AH0 T
poetry P OW1 AH0 T R IY0
police P AH0 L IY1 S
policy P AA1 L AH0 S IY0
politics P AA1 L AH0 T IH2 K S
pollution P AH0 L UW1 SH AH0 N
pool P UW1 L
population P AA2 P Y AH0 L EY1 SH AH0 N
position P AH0 Z IH1 SH AH0 N
possession P AH0 Z EH1 SH AH0 N
possibility P AA2 S AH0 B IH1 L AH0 T IY0
pot P AA1 T
potato P AH0 T EY1 T OW2
poverty P AA1 V ER0 T IY0
power P AW1 ER0
presence P R EH1 Z AH0 N S
president P R EH1 Z AH0 D AH0 N T
pressure P R EH1 SH ER0
price P R AY1 S
pride P R AY1 D
priest P R IY1 S T
principle P R IH1 N S AH0 P AH0 L
priority P R AY0 AO1 R AH0 T IY0
prison P R IH1 Z AH0 N
problem P R AA1 B L AH0 M
procedure P R AH0 S IY1 JH ER0
process P R AA1 S EH2 S
product P R AA1 D AH0 K T
production P R AH0 D AH1 K SH AH0 N
profession P R AH0 F EH1 SH AH0 N
professor P R AH0 F EH1 S ER0
profit P R AA1 F AH0 T
program P R OW1 G R AE2 M
progress P R AA1 G R EH2 S
project P R AA1 JH EH0 K T
promotion P R AH0 M OW1 SH AH0 N
property P R AA1 P ER0 T IY0
proposal P R AH0 P OW1 Z AH0 L
protection P R AH0 T EH1 K SH AH0 N
psychology S AY0 K AA1 L AH0 JH IY0
purchase P ER1 CH AH0 S
purpose P ER1 P AH0 S
quality K W AA1 L AH0 T IY0
quantity K W AA1 N T AH0 T IY0
quarter K W AO1 R T ER0
queen K W IY1 N
quiet K W AY1 AH0 T
race R EY1 S
radio R EY1 D IY0 OW2
rain R EY1 N
range R EY1 N JH
rate R EY1 T
ratio R EY1 SH IY0 OW2
reaction R IY0 AE1 K SH AH0 N
reality R IY0 AE1 L AH0 T IY0
reason R IY1 Z AH0 N
recipe R EH1 S AH0 P IY0
record R EH1 K ER0 D
recording R IH0 K AO1 R D IH0 NG
reflection R IH0 F L EH1 K SH AH0 N
refrigerator R IH0 F R IH1 JH ER0 EY2 T ER0
region R IY1 JH AH0 N
relation R IY0 L EY1 SH AH0 N
relationship R IY0 L EY1 SH AH0 N SH IH2 P
religion R IH0 L IH1 JH AH0 N
repair R IH0 P EH1 R
replacement R IH0 P L EY1 S M AH0 N T
republic R IY0 P AH1 B L IH0 K
reputation R EH2 P Y AH0 T EY1 SH AH0 N
requirement R IY0 K W AY1 R M AH0 N T
research R IY0 S ER1 CH
resident R EH1 Z AH0 D AH0 N T
resolution R EH2 Z AH0 L UW1 SH AH0 N
resource R IY1 S AO0 R S
response R IH0 S P AA1 N S
responsibility R IY0 S P AA2 N S AH0 B IH1 L AH0 T IY0
restaurant R EH1 S T ER0 AA2 N T
revenue R EH1 V AH0 N UW2
review R IY0 V Y UW1
revolution R EH2 V AH0 L UW1 SH AH0 N
reward R IY0 W AO1 R D
rhythm R IH1 DH AH0 M
rice R AY1 S
ring R IH1 NG
river R IH1 V ER0
road R OW1 D
rock R AA1 K
role R OW1 L
roof R UW1 F
room R UW1 M
root R UW1 T
rope R OW1 P
route R UW1 T
routine R UW0 T IY1 N
rule R UW1 L
safety S EY1 F T IY0
salad S AE1 L AH0 D
salary S AE1 L ER0 IY0
sale S EY1 L
salt S AO1 L T
sample S AE1 M P AH0 L
sand S AE1 N D
satisfaction S AE2 T AH0 S F AE1 K SH AH0 N
sauce S AO1 S
scale S K EY1 L
scene S IY1 N
schedule S K EH1 JH UW0 L
scheme S K IY1 M
scholarship S K AA1 L ER0 SH IH2 P
school S K UW1 L
science S AY1 AH0 N S
scientist S AY1 AH0 N T IH0 S T
screen S K R IY1 N
script S K R IH1 P T
season S IY1 Z AH0 N
seat S IY1 T
secretary S EH1 K R AH0 T EH2 R IY0
section S EH1 K SH AH0 N
sector S EH1 K T ER0
security S IH0 K Y UH1 R AH0 T IY0
selection S AH0 L EH1 K SH AH0 N
self S EH1 L F
sense S EH1 N S
series S IH1 R IY0 Z
service S ER1 V AH0 S
session S EH1 SH AH0 N
shape SH EY1 P
shelter SH EH1 L T ER0
shift SH IH1 F T
shirt SH ER1 T
shock SH AA1 K
shoe SH UW1
shop SH AA1 P
shoulder SH OW1 L D ER0
shower SH AW1 ER0
side S AY1 D
sign S AY1 N
signal S IH1 G N AH0 L
signature S IH1 G N AH0 CH ER0
silence S AY1 L AH0 N S
silver S IH1 L V ER0
singer S IH1 NG ER0
sister S IH1 S T ER0
site S AY1 T
situation S IH2 CH UW0 EY1 SH AH0 N
size S AY1 Z
skill S K IH1 L
skin S K IH1 N
sky S K AY1
smoke S M OW1 K
snow S N OW1
society S AH0 S AY1 AH0 T IY0
software S AO1 F T W EH2 R
soil S OY1 L
soldier S OW1 L JH ER0
solution S AH0 L UW1 SH AH0 N
son S AH1 N
song S AO1 NG
sort S AO1 R T
soul S OW1 L
soup S UW1 P
source S AO1 R S
space S P EY1 S
speaker S P IY1 K ER0
speech S P IY1 CH
speed S P IY1 D
spirit S P IH1 R AH0 T
sport S P AO1 R T
spot S P AA1 T
spring S P R IH1 NG
square S K W EH1 R
staff S T AE1 F
stage S T EY1 JH
standard S T AE1 N D ER0 D
star S T AA1 R
statement S T EY1 T M AH0 N T
station S T EY1 SH AH0 N
status S T AE1 T AH0 S
steak S T EY1 K
steel S T IY1 L
step S T EH1 P
stock S T AA1 K
stomach S T AH1 M AH0 K
storage S T AO1 R AH0 JH
store S T AO1 R
storm S T AO1 R M
story S T AO1 R IY0
stranger S T R EY1 N JH ER0
strategy S T R AE1 T AH0 JH IY0
stream S T R IY1 M
street S T R IY1 T
strength S T R EH1 NG K TH
stress S T R EH1 S
structure S T R AH1 K CH ER0
student S T UW1 D AH0 N T
studio S T UW1 D IY0 OW2
stuff S T AH1 F
style S T AY1 L
subject S AH1 B JH IH0 K T
substance S AH1 B S T AH0 N S
success S AH0 K S EH1 S
sugar SH UH1 G ER0
summer S AH1 M ER0
sun S AH1 N
supermarket S UW1 P ER0 M AA2 R K AH0 T
surface S ER1 F AH0 S
surgery S ER1 JH ER0 IY0
surprise S ER0 P R AY1 Z
swimming S W IH1 M IH0 NG
system S IH1 S T AH0 M
table T EY1 B AH0 L
tale T EY1 L
talent T AE1 L AH0 N T
tank T AE1 NG K
target T AA1 R G AH0 T
task T AE1 S K
tax T AE1 K S
tea T IY1
teacher T IY1 CH ER0
team T IY1 M
technique T EH0 K N IY1 K
technology T EH0 K N AA1 L AH0 JH IY0
teenager T IY1 N EY2 JH ER0
telephone T EH1 L AH0 F OW2 N
television T EH1 L AH0 V IH2 ZH AH0 N
temperature T EH1 M P R AH0 CH ER0
tennis T EH1 N AH0 S
tension T EH1 N SH AH0 N
term T ER1 M
test T EH1 S T
text T EH1 K S T
theater TH IY1 AH0 T ER0
theme TH IY1 M
theory TH IH1 R IY0
therapy TH EH1 R AH0 P IY0
thread TH R EH1 D
throat TH R OW1 T
thunder TH AH1 N D ER0
ticket T IH1 K AH0 T
tip T IH1 P
tissue T IH1 SH UW0
title T AY1 T AH0 L
toe T OW1
tomato T AH0 M EY1 T OW2
tone T OW1 N
tongue T AH1 NG
tool T UW1 L
tooth T UW1 TH
topic T AA1 P IH0 K
total T OW1 T AH0 L
tour T UH1 R
tourist T UH1 R AH0 S T
towel T AW1 AH0 L
tower T AW1 ER0
town T AW1 N
toy T OY1
track T R AE1 K
trade T R EY1 D
tradition T R AH0 D IH1 SH AH0 N
traffic T R AE1 F IH0 K
transition T R AE0 N Z IH1 SH AH0 N
transportation T R AE2 N S P ER0 T EY1 SH AH0 N
treatment T R IY1 T M AH0 N T
tree T R IY1
trend T R EH1 N D
trial T R AY1 AH0 L
trick T R IH1 K
trip T R IH1 P
trouble T R AH1 B AH0 L
truck T R AH1 K
truth T R UW1 TH
tune T UW1 N
tunnel T AH1 N AH0 L
type T AY1 P
uncle AH1 NG K AH0 L
union Y UW1 N Y AH0 N
unit Y UW1 N IH0 T
university Y UW2 N AH0 V ER1 S AH0 T IY0
user Y UW1 Z ER0
vacation V EY0 K EY1 SH AH0 N
value V AE1 L Y UW0
variety V ER0 AY1 AH0 T IY0
vegetable V EH1 JH T AH0 B AH0 L
vehicle V IY1 IH0 K AH0 L
version V ER1 ZH AH0 N
victim V IH1 K T AH0 M
victory V IH1 K T ER0 IY0
video V IH1 D IY0 OW2
view V Y UW1
village V IH1 L AH0 JH
violence V AY1 AH0 L AH0 N S
vision V IH1 ZH AH0 N
visitor V IH1 Z AH0 T ER0
voice V OY1 S
volume V AA1 L Y UW0 M
wall W AO1 L
war W AO1 R
warning W AO1 R N IH0 NG
wave W EY1 V
wealth W EH1 L TH
weapon W EH1 P AH0 N
weather W EH1 DH ER0
web W EH1 B
website W EH1 B S AY2 T
wedding W EH1 D IH0 NG
week W IY1 K
weekend W IY1 K EH2 N D
weight W EY1 T
wheel W IY1 L
wife W AY1 F
wind W IH1 N D
window W IH1 N D OW0
wine W AY1 N
wing W IH1 NG
winner W IH1 N ER0
winter W IH1 N T ER0
wire W AY1 ER0
wisdom W IH1 Z D AH0 M
woman W UH1 M AH0 N
women W IH1 M AH0 N
wood W UH1 D
wool W UH1 L
worker W ER1 K ER0
worth W ER1 TH
writer R AY1 T ER0
writing R AY1 T IH0 NG
yard Y AA1 R D
youth Y UW1 TH
zone Z OW1 N
"""

# Parsed lazily-once at import; ~1 ms for a few thousand lines.
SUPPLEMENT: dict[str, str] = {}
for _line in _DATA.splitlines():
    _line = _line.strip()
    if not _line or _line.startswith("#"):
        continue
    _w, _, _p = _line.partition(" ")
    SUPPLEMENT[_w] = _p
